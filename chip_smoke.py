#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--profile]

Phases; any failure ends the run with a nonzero exit and no result line:

1. the card's name and power limit, and the build of every kernel from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, started together);
2. kernel parity: each kernel against its plain PyTorch version at the
   shapes of the serving paths, with its time on the card beside the bound,
   the plain version and one library call where there is one:
   - the masked GEMM at SmolLM-135M's shapes in bf16 and float32, the layer
     GEMMs at M = 4 (decode and the prefill unembed), 512 (serving prefill,
     4 x 128), 1024 and 8192 (long prefill, 4 x 2048), the tied unembed at
     M = 4 and 1024. In bf16 the kernel the path picks (decode at M <= 16,
     mma above) runs on the bf16 copy of w and on the fp32 master read in
     place, and the two must give the same bits; v1 is timed beside them,
     with the fp32->bf16 cast and ``torch.matmul`` on pre-masked w. The mask
     is packed to bits once (timed), and every kernel's bound counts those
     bits, as every kernel reads them;
   - flash attention at SmolLM's heads, S = 128 and 2048, and at hymba's
     (25 / 5, window 1024) at S = 2048, then at the reference zoo's other
     head dims at 4 x 2048: hubert-xlarge's 16 heads at D = 80 (an encoder,
     not causal), phi3-mini's 32 / 32 at D = 96 and qwen3-0.6b's 16 / 8 at
     D = 128; in bf16 the mma kernel and v1 are both held and timed;
   - the selective scan at (B, L, D, N) = (4, 128, 8192, 16) (falcon-mamba's
     serving prefill), (4, 128, 3200, 16) (hymba's), (4, 2048, 3200, 16)
     and (4, 2048, 8192, 16) (the two long prefills), a ragged (2, 37, 11,
     4), a larger state (2, 256, 1024, 64) and an odd one (2, 100, 300, 17),
     with u, B and C in bf16 and dt in fp32 as the model gives them, and all
     in float32; each row prints its launch plan (``scan_plan``), and its
     bound is the largest of its bytes, its fp32 operations and its
     exponentials on the special-function units;
   - the masked GEMM in bf16 and float32 at every falcon-mamba-7b and
     hymba-1.5b GEMM shape at M = 4 and 512, and at hymba's layer shapes at
     M = 8192; then at llama3-405b's five distinct GEMM shapes, the zoo's
     widest (its 16384 x 128256 unembed holds 97.9% of INT_MAX weights), at
     M = 4 and 512 (no llama3 model runs on the card);
3. int8 decode attention (kernel #3) against its plain version, float32
   and bf16 q, at (B, Hq, Hkv, S, D) = (1, 2, 2, 512, 32) (the reference's
   tune-suite shape), SmolLM-135M's decode (4, 9, 3, 2048, 64) at valid
   lengths 2048, 1000 and 0, the same heads at B = 32, hymba-1.5b's
   (4, 25, 5, 1024, 64) (its KV ring holds 1024 tokens) and phi3-mini's
   (4, 32, 32, 2048, 96). Each cell prints the
   kernel's time at the heuristic bkv with the split count and blocks of
   its split-KV grid, its bytes bound at 3.35 TB/s (the valid prefix of
   int8 K and V with their fp32 scales, q and o in q's dtype), the plain
   version's time and a library yardstick labelled as such: SDPA on K/V
   already dequantized, which reads more than twice the bytes and is not a
   port. A cell whose cache holds more than one tile and whose (sequence,
   KV head)s are fewer than two per SM must launch more blocks than it has
   (sequence, KV head)s; two launches, and an int length against a
   device-resident one, must give the same bits. At the heuristic bkv the
   splits are also forced to 1 and to one per tile (held to the plain
   version and timed, beside the plan's). Then every bkv of each cell's
   lattice that the geometry lint accepts is launched and held to the
   plain version with float32 q at the table's tolerance (a key dropped or
   counted twice per tile moves an output by about 1e-3, which bf16's
   tolerance would pass) and with bf16 q, with its split count, and the
   rejected ones are listed with their codes;
4. paged decode attention (kernel #4) over a pool of 8-token pages laid out
   by ``PageAllocator`` (every other chain freed and allocated again, so
   the ids are out of order): SmolLM's heads, 32 slots with ragged lengths
   up to 2048, one of 0 and one ending mid-page, stale page ids past each
   chain. One call is the main path; it is held to the plain version, and
   the same call with the stale ids replaced by ids far outside the pool
   must give the same bits; the splits and blocks are logged, and the
   splits forced to 1 and to one per tile are held to the plain version.
   The same runs at phi3-mini's heads (32 / 32, D = 96) over a pool of its
   own;
5. the kernel autotuner (``repro_torch.tune.tune_many``) from an empty
   cache over the dense cells (bf16; the tune-suite shape in float32, as
   the reference tunes it), printing the heuristic and tuned bkv with their
   split counts and their microseconds, the speedup, the H100 roofline
   fraction, the evaluated and
   rejected candidates with their codes, and the recorder's span count.
   With the tuned table as the process cache, ``decode_attention`` called
   with no bkv must launch the tuned tile and still match the plain
   version. The table is saved to ``build/tune_decode_attention.json``.
   Then ``tune_spaces``: from an empty cache, the other three kernels'
   spaces at ``TUNE_CELLS`` (the masked GEMM's K slices at SmolLM's and
   falcon-mamba's decode GEMMs and SmolLM's long-prefill ones in bf16 on
   the fp32 master, and ``v1`` at M = 4 and 512; flash's tile at SmolLM's,
   qwen3's and hubert's heads in bf16 and float32; the scan's lanes at
   falcon-mamba's and hymba's prefills), each printed as the decode cells
   are, the roofline fraction at the dtype's peak and the shared memory
   with them. With that table installed, each wrapper called with no
   blocks must launch the tuned blocks (its ``last_splits``,
   ``last_blocks`` or ``last_plan``) and match its plain version at
   ``dtype_tol``. The whole table goes to ``build/tune_table.json``; the
   committed ``default_cache.json`` is built from two runs' tables
   (``tools/default_table.py``). Last, ``lint_kernels`` over
   ``kernel_launches(cfg)`` of every registered configuration must find
   nothing, and ``analyze_stack``'s cheap passes (recompile, sharding,
   kernels) over the seven archs the stack lints must find no key outside
   the committed baseline (``src/repro_torch/analysis/baseline.json``),
   falcon-mamba-7b, hymba-1.5b and hubert-xlarge refused; the donation
   pass of the reduced SmolLM-135M on the CPU gives the classification
   phases 6, 12 and 13 are held to. Phases 3-5 run with an empty cache installed (they time the
   heuristics); every other phase runs the committed table, which the
   process cache loads by default, as a user's run does;
6. serve SmolLM-135M at full published width (random weights, seed 0) on a
   256x256 array with 10% of its PEs faulty, through ``ServeEngine`` in
   ``kernel`` mode: 4 prompts of 128 tokens, 32 greedy new tokens, in bf16
   and in float32. The served sequences are re-run teacher-forced through
   the plain ``fap`` context and the logits are gated. After the bf16
   gates, the donation pass runs the engine's sample-decode once on the
   prefill's cache (every carried subject kept or rebound as in the CPU
   run, 211 masked-GEMM kernel launches), and the dry run's decode cell at
   the engine's batch and capacity on a 1 x 1 mesh must give the live
   params' and cache's bytes exactly;
7. long prefill: SmolLM's ``prefill`` at 4 x 2048 tokens in ``kernel`` mode
   with the flash kernel, against the plain path (``fap`` context, dense
   attention): logits and KV cache;
8. serve falcon-mamba-7b at full published width (64 layers, d_inner 8192)
   the same way in bf16 and float32, on the same faulty chip;
9. serve hymba-1.5b at full published width the same way in bf16 and
   float32;
10. hymba's long prefill at 4 x 2048 through the kernels (masked GEMM,
    flash with its 1024-token window, the scan) against the plain path
    (``fap`` context, dense attention and the scan's plain version), in bf16
    and in float32: logits, KV ring, conv tail and SSM state;
11. eFAT on the card (``efat_phase``): the sequence of
    ``examples/fleet_retraining.py`` through the port — paper-mlp
    pretrained 600 steps, the constraint its accuracy less 0.03, 100
    correlated chips (``correlated_family(0, 100, 32, 32, 0.07, 0.025)``),
    Step 1 (5 repeats, 400 steps at most), ``EFAT.run`` and the baselines
    ``individual``, ``fixed`` (80 steps a chip) and ``random-merge``. It
    prints the Step-1 map, the comparison table, the scheduler's report,
    each stage's wall time, population steps per second at width 16 beside
    serial, and device ops (kernel launches) per population step from two
    ``torch.profiler`` traces. Gates: the reference's serial/population pin
    on the card (5 chips at rates 0.02-0.22, equal steps to baseline - 0.05,
    ``train_batch`` at [25, 40, 10] within ``dtype_tol(float32,
    atol_scale=100)``, metrics within 2e-3); every shipped weight exactly 0
    on its job's faulty PEs; every chip's shipped weights through
    ``classifier_forward`` in ``kernel`` mode (the masked GEMM's ``v1``)
    against ``fap`` mode on the 4 eval batches at ``dtype_tol(float32)``,
    accuracy within 1/2048 and 4 x chips x batches ``v1`` launches; eFAT's
    total steps at most ``individual``'s. Stage "sharded":
    (a) ``ClassifierFATTrainer(engine="sharded")`` on a pop mesh of 4 over
    the card repeated, from the pin trainer's base params, against it on
    the pin's 5 chips: equal steps to the constraint and
    ``measure_resilience`` table (rates 0.06 / 0.14 / 0.2, 2 repeats, 100
    steps, seed 5), ``train_batch`` at the pin's tolerance, metrics within
    2e-3; (b) the same on a 2 x 2 fleet mesh, member params stored split
    two ways (resident bytes at mesh position 0 at most half the member's
    total, x 1.05 + 1 KiB); (d) ``compute="sharded"`` on the 2 x 2 mesh
    (the math on the split pieces, each masked through its rolled map):
    equal steps, ``train_batch`` at the pin's tolerance, ``kernel``-mode
    metrics within 2e-3 of the pin's with one chip-batched ``v1`` a weight
    piece (pieces counted from the rules x eval batches x pop slices),
    resident bytes at mesh position 0 exactly the rules' split; (c) every
    chip's shipped weights in ``kernel``
    mode through the trainer's ``evaluate_batch`` (width 16): accuracy
    within 1/2048 of the serial check's, and 4 layers x 4 eval batches x 7
    chunks = 112 ``v1`` launches, every one chip-batched; the chip-batched
    ``v1`` at the shapes it gives (16 chips, M = 512) against its plain
    version at ``dtype_tol(float32)``; then the kernel-mode evaluation
    alone, timed in turns (3 rounds, median): the 1,600 single-chip
    forwards with no host read, ``evaluate_metric`` a chip, and
    ``evaluate_batch``;
12. LM fault-aware training on the card (``lm_phase``): SmolLM-135M at
    full width, batch 8 x 64, on ``random_fault_map(0, 256, 256, 0.1)``.
    (a) the training CLI (``repro_torch.launch.train.main``) in process: 40
    steps with checkpoints every 10 under ``build/lm_ckpt``, interrupted
    after 30 as a preemption would stop it (a ``KeyboardInterrupt`` from
    the train step), then the same command run again, which resumes from
    the step-30 checkpoint; the resumed params must equal a straight
    40-step run's within ``dtype_tol(float32, atol_scale=100)``, no step
    retried or restarted and every loss finite; it prints train steps/s
    (host clock, card synchronized).
    (b) ``LMFATTrainer`` on both engines (TF32 off, the mean loss as the
    metric): ``train_batch`` on 3 chips (rates 0.05-0.2, budgets [5, 8,
    3]), ``evaluate_batch`` within 2e-3. In float64 (``dtype`` and
    ``param_dtype``) every param must agree within ``dtype_tol(float32,
    atol_scale=100)``. In float32 at most 10 elements may pass that atol,
    each by at most 2 x lr: the two engines' first gradients disagree in
    sign on a few hundred of 134.5M elements whose gradient is at
    float32's noise floor (about 1e-9), and Adam's first step turns each
    sign into a step of the full learning rate either way; in float64 the
    gradients sit far above that noise and no sign flips.
    (c) ``LMFATTrainer`` at the reference's defaults in bf16 (pretraining
    150 steps, population 4) with the mean loss as the metric (the
    accuracy stays 0 at vocab 49152): steps-to-constraint for 4 chips
    (``random_fault_map(i, 256, 256, 0.1)``, 40 steps at most), then FAT
    to those steps. The constraint lies halfway between the healthy loss
    and the least-hurt chip's, so every chip trains; the faults must raise
    the loss and no chip may stop at step 0; the losses are printed.
    (d) each chip's trained weights through the card kernels (``kernel``
    mode) against ``fap`` mode on the eval batches, bf16 anchored (as the
    serving gates) and float32 at ``atol_scale=50``, the metrics of
    ``evaluate_batch(mode="kernel")`` within 2e-3; one 4 x 2048 forward and
    ``loss_fn`` with ``attn_impl="kernel"`` against ``fap`` with dense
    attention in bf16 and float32, its loss and accuracy within 2e-3.
    Every run must launch 211 masked GEMMs a
    forward (only ``mma`` in bf16, only ``v1`` in float32) and, at 4 x 2048,
    30 flash kernels (``mma`` / ``v1``); the deployment's metric loop runs
    one chip at a time (``evaluate_metric``). Stage "sharded", float32 from
    (c)'s base params: ``LMFATTrainer(engine="sharded")`` on a 2 x 2 fleet
    mesh over the card repeated trains ``random_fault_map(c, 256, 256,
    0.05 (c + 1))``, c < 4, at budgets [4, 2, 4, 1], held to the vmap
    engine's fit by the float32 pin rule of (b), its member state stored
    split as the rules say (resident bytes at mesh position 0 equal to the
    leaves' bytes with every "model" dim halved); then those chips in
    ``kernel`` mode through its ``evaluate_batch``: 211 chip-batched ``v1``
    launches a forward of each pop slice (844 in all), the metrics within
    2e-3 of ``fap`` and within 1e-6 of ``evaluate_metric`` one chip at a
    time, and the chip-batched ``v1`` for 2 chips at M = 512 at every
    SmolLM GEMM shape against its plain version. Then ``compute="sharded"``
    on a 2 x ``LM_TP_MODEL`` (4) mesh (at 2 no SmolLM piece starts off the
    256 x 256 grid): ``lm_tp_parity`` (layer 0's GEMMs and the tied unembed
    of 2 chips through ``fault_linear`` under ``vmap``, one chip-batched
    ``v1`` a piece, the joined output against the whole weight's plain
    product, each piece against its plain version on its rolled map, at
    least one piece off the grid); the 4 chips of the gathered run in
    ``kernel`` mode through its ``evaluate_batch``: 484 pieces a forward x
    2 eval batches x 2 pop slices, all chip-batched ``v1``, the metrics
    within 2e-3 of ``fap`` and 1e-6 of one chip at a time; its own fit,
    held to the vmap engine's by the float32 pin rule, resident bytes
    exactly the rules' split. Stage "donation", after
    (c): the donation pass over one bf16 train step and one population fit
    (4 chips, one step each, ``fap`` as (c) trains), every carried subject
    classified as in the CPU run, the fit's params0 keeping its storage and
    bits, no masked-GEMM kernel launch. (e) the population step at width
    4 (median of timed fits), device ops and busy share from two
    ``torch.profiler`` traces, peak device memory, each stage's seconds.
    Stage "families" (``lm_families``), float32 at published widths, the
    phase's trainers freed first: (a) falcon-mamba-7b at depth 4, 2 chips
    at budgets [2, 3] through the population and serial engines (the
    float32 pin rule), in the fits a forward and a backward scan kernel a
    layer a step (chip-batched in the population's) and no GEMM launch;
    one ``ssm_block``'s gradient on the card against the CPU's, each leaf
    within 1e-5 of its largest gradient (``ssm_grad_gate``); the backward
    kernel at the population fit's launch against its plain version, timed;
    ``kernel``-mode evaluation with every scan and GEMM chip-batched,
    within 2e-3 of ``fap`` and 1e-6 of one chip at a time. (b) hymba-1.5b
    at depth 4 under ``compute="sharded"`` on 2 x 4 (4 chips at [4, 2, 4,
    1]) against the vmap engine (the pin rule; the untied embedding's
    elements each within its limit, their count at most the serial
    engine's plus 10), the fits' forward and backward scans, resident
    bytes the rules' split,
    ``lm_tp_parity`` on its SSM and MLP GEMMs and ``lm_head``, the
    chip-batched scan a channel piece against its plain version, then
    ``kernel``-mode evaluation: one chip-batched scan a channel piece and
    one chip-batched ``v1`` a weight piece, within 2e-3 of ``fap`` and 1e-6
    of one chip at a time. (c) mixtral-8x22b at depth 1: ``wg``, ``wu`` and
    ``wd`` split 4 ways over the experts for 2 chips, one chips x experts
    ``v1`` a piece, joined against the whole stack's launch and each piece
    against its plain version; the population fit reckoned against the
    card's memory (``family_fit_reckoning``, which undercounts: it does not
    fit), and the engine's member gradient under ``vmap`` (the router included) against
    plain autograd;
13. continuous serving with online fault detection (``continuous_phase``):
    SmolLM-135M at full width through ``ContinuousBatchingEngine`` in
    ``kernel`` mode on the same chip, 8 slots, 8-token pages, a pool of 1024
    pages (189 MB in bf16), chains of up to 96 pages, buckets 32-256,
    chunks of 256, packs of up to 4. Traffic (``continuous_traffic``): 24
    requests from ``np.random.default_rng(0)``, 16 prompts of 8-120 tokens,
    5 of 121-256, and 300, 513 and 700 (2, 3 and 3 chunks), greedy budgets
    of 4-48, 12 arriving at 0 and the rest at dispatches 1-40. First the
    masked GEMM's wrapper is held to ``masked_matmul_ref`` at ``dtype_tol``
    on the same x, w and ok at every M the path launches, in bf16 (the fp32
    master, as kernel mode hands it over) and float32, on the model's own
    weights: layer 0's seven GEMMs at M = 8 (a decode dispatch) and 32, 64,
    128 and 256 (packed admissions and chunks), the tied unembed at M = 8,
    4 and 1, and ``masked_matmul_checksummed`` on the probe weight at M =
    4 + 1 and 256 + 1 under the chip's map and the injected one. Each run
    first warms the closed program set (``warmup()``; no program may then
    be first run during traffic). (a) bf16 without probes: the served
    logprobs against the plain path teacher-forced, anchored to plain
    float32 (RMS at most 1.5 times plain bf16's own); (b) float32 without
    probes: the served logprobs elementwise, every request's tokens equal to
    the static ``ServeEngine``'s but past a near-tie of 1e-3; (c) bf16 with a
    probe every 8 dispatches and ``default_slo_rules()`` on unchanged
    silicon: (a)'s tokens and logprob bits, no detection, no alert; (d)
    bf16 with ``random_fault_map(42, 256, 256, 0.02)`` joining the map at
    dispatch 24 (``set_silicon``): detected by dispatch 48, the
    reconstructed delta within the true new faults, ``detect.new_faults``
    fired. It prints each run's stats, tokens/s, ms a decode dispatch, TTFT
    p50 and p99 (all with a ``Recorder`` attached, which synchronizes after
    each admission and chunk) and the program counts; with ``--profile``
    run (a)'s busy share and, from a trace of the CPU too, the host's cost
    of a decode dispatch by op group (``host_costs``). Last, the donation
    pass over run (d)'s engine's three programs (the decode, a packed
    admission, a chunk; one dispatch each on fresh slot state), every
    carried subject classified as in the CPU run, 211 masked-GEMM kernel
    launches a dispatch;
14. fleet serving (``fleet_phase``): SmolLM-135M at full width in
    ``kernel`` mode on chips ``random_fault_map(c, 256, 256, 0.05 * c)``.
    (a) ``FleetServeEngine``, 8 chips (params from seed c // 4, chip 0
    healthy), the four 128-token prompts shared, 32 greedy new tokens, in
    bf16 and float32: each chip against its own ``ServeEngine``, float32
    tokens equal but past a near-tie of 1e-3 and logprobs at
    ``dtype_tol(float32, atol_scale=50)``, bf16 anchored; the faulty chips'
    tokens differ from chip 0's; every masked GEMM one chip-batched launch,
    211 a fused decode dispatch. (b) ``ShardedFleetServeEngine``, 4 chips
    (chip 0 a zero-fault map), each its own stream of 12 requests from
    ``default_rng(c)`` (8-256 tokens and one of 300, budgets 4-48, arrivals
    at dispatches 0-20), 8 slots, 8-token pages, 512 pages a chip, buckets
    32-256, chunks of 256, packs of 4: bf16 anchored, float32 tokens equal
    to each chip's own ``ContinuousBatchingEngine``; probes every 8
    dispatches on unchanged silicon detect nothing and change no bit; a 2%
    map joined to chip 2's at dispatch 24 (``set_silicon``) is detected on
    chip 2 alone within 3 probes, its delta within the true new faults,
    the other chips' tokens those of the control run, ``detect.new_faults``
    fired; 211 chip-batched launches a fused decode dispatch, admissions and
    probes single-chip. (c) fleet tokens/s, ms a fused dispatch, TTFT p50 /
    p99 per chip, the per-chip engines in turn and the dispatch
    amortization; the chip-batched masked GEMM for 8 chips held to its
    plain version at every shape (a) and (b) give it (M = 4, 8 and 512, bf16
    x through ``decode`` and ``mma`` and float32 x through ``v1``, at
    ``dtype_tol`` of the dtype, the tied unembed's weight k-contiguous),
    and timed at a decode step's shapes (M = 4) and (a)'s prefill (M = 512) against its bound,
    the same launches one chip at a time, ``torch.bmm`` on pre-masked bf16
    w and the plain version; ``--profile`` adds (b)'s busy share. (d)
    hymba-1.5b (4 chips, all 32 layers) and mixtral-8x22b (2 chips, depth
    1) at full width through ``FleetServeEngine`` in bf16, 4 x 128-token
    prompts shared, 16 greedy tokens: each chip anchored and held to its
    own ``ServeEngine`` (tokens equal but at a bf16 near-tie), the faulty
    chips' tokens differ from chip 0's; one chip-batched launch a masked
    GEMM (hymba 353 a step; mixtral's 3 expert GEMMs a step one chips x
    experts launch each) and a scan (hymba's prefill: 32); the chips x
    experts GEMM on the stacked ``wg`` and ``wd`` at M = 8 and 160 an expert
    (decode, mma, v1) and the chip-batched scan at hymba's prefill (per-chip
    and shared a and d, bf16 and float32) held to their plain versions and
    timed beside their bounds, ``torch.bmm`` on pre-masked w (the GEMM) and
    the plain versions;
15. the rest of the model zoo at full published width on the same chip in
    ``kernel`` mode. First qwen3-0.6b at full depth (qk_norm, D = 128, the
    tied 151,936-row unembed), a dense decoder, through phases 6 and 7's
    gates: served in bf16 (anchored) and float32, then its 4 x 2048 prefill
    through flash at D = 128. Then ``zoo_phase``, each model against the
    plain path (``fap``, dense attention): float32 elementwise
    (``atol_scale=50``), bf16 anchored to plain float32 (ANCHOR_RATIO), no
    fp32->bf16 weight cast. (a) mixtral-8x22b at depth 4 of 56 (one layer is 10.1 GB of fp32
    master) served in bf16 and float32: 33 masked GEMMs a step, 12 of them
    ONE expert-batched launch each for all 8 experts under the one mask;
    then the expert-batched GEMM on layer 0's ``wg`` and ``wd`` at M = 8 and
    160 a expert, held and timed beside its bound and ``torch.bmm``. (b)
    hubert-xlarge's encoder ``forward`` at 4 x 1024 frames, flash
    non-causal at D = 80; ``ServeEngine`` refuses it. (c) internvl2-26b at
    depth 12 of 48: 4 x (256 patches + 128 tokens) prefilled, 16 greedy
    decode steps. Each model's seconds are printed;
16. the record: each model's bf16 decode step of masked GEMMs as kernel
    mode runs it (the decode kernel on the fp32 master, no cast) beside the
    path-level yardstick "cast + ``torch.matmul``"; the long prefills' layer
    GEMMs; each model's float32 decode step through v1 and hymba's float32
    long-prefill layer GEMMs beside ``torch.matmul`` on pre-masked fp32 w;
    hymba's float32 long prefill split into its GEMMs, flash and scan
    launches (each timed alone) and the rest; then a ``{"kernels": [...]}`` line with one entry per kernel
    variant (``masked_matmul.decode``, ``.mma``, ``.v1`` with phase 11's
    launches as ``launches_efat_deploy`` and the chip-batched launches of
    phases 11 and 12's population evaluations as ``launches_pop_eval``,
    ``flash_attention.mma``, ``.v1``, and the scan and decode kernels;
    the masked GEMM's ``mma`` and ``v1`` and flash carry phase 12's
    deployment launches as ``launches_lm_eval``, and the masked GEMM's
    three variants phase 13's as ``launches_continuous`` and phase 14's
    chip-batched ones as ``launches_fleet``, and their worst chip-batched
    error as ``max_abs_err_fleet``; ``masked_matmul.decode.chips8``
    is phase 14's chip-batched decode step; ``masked_matmul.decode``'s
    ``launches_by_offset`` counts the main path's decode launches whose w
    runs start off 16 bytes (hymba-1.5b's untied head), ``.mma``'s
    ``launches_by_copies`` those that copied an operand TMA refuses;
    ``masked_matmul.<variant>.experts``
    phase 15's expert-batched launches with mixtral's rows,
    ``selective_scan_bwd`` the scan's backward kernel with phase 12's
    stage "families" fits' launches and (a)'s timed row, and
    ``launches_zoo`` on the masked GEMM's and flash's entries), the card's
    line, and last the ``{"ok": true, "device": ...}`` line.

``--profile`` adds, after each served model (SmolLM in bf16, falcon-mamba,
hymba, qwen3-0.6b in bf16, and phase 13's run (a)), a run of 8 new tokens (phase 13: its whole
traffic) once untraced (wall time) and once under
``torch.profiler`` tracing the card alone; device time by kernel goes to
``build/profile_serve.txt``, and the busy share is the traced kernel time
over the untraced wall time. Phase 13 then serves its traffic once more
under a trace of the CPU and the card, with each decode dispatch's enqueue
and the model's op groups (the masked GEMM's ``fault_linear``, norms, RoPE,
the attention block's page scatter and chain gather, dense attention, the
MLP's elementwise ops, the unembed) in ``record_function`` ranges, and
prints each group's calls, host microseconds and torch ops a dispatch.

Launch counts are set to 0 just before each main-path run (the tuner of
phase 5 for the dense decode kernel, the paged call of phase 4, the
generate calls of phases 6, 8 and 9, the kernel-path prefills of phases
7 and 10, bf16 and hymba's float32, phase 11's deployment checks,
serial and chip-batched, each of phase 12's kernel-mode runs and its
sharded and families stages' evaluations, each of phase 13's four serves,
each of phase 14's six fleet runs and each of phase 15's model runs) and
read just after it; parity and
timing launches are not counted.
Phase 13 gates each variant's count against its dispatches: 211 ``decode``
a decode dispatch (30 layers x 7 at M = 8, and the tied unembed), 210
``mma`` and one ``decode`` (the unembed at M = 4 or 1) a packed admission
or a chunk, one ``decode`` a canary probe (M = 5) and one ``mma`` a
structured probe (M = 257); in float32 every one is ``v1``; flash
attention, the scan and the int8 decode kernels are not launched (the
paged decode gathers each slot's chain and runs dense attention in the
model's dtype, as the reference does). The masked GEMM and flash count launches
per variant: bf16 runs must launch only the bf16 kernels, float32 runs only
v1, and every variant must be launched on its main path. A bf16 serve in
kernel mode is also watched for one short run: no fp32 -> bf16 conversion of
a tensor with a GEMM weight's shape may happen.
Tolerances, each printed beside its error:

- the masked GEMM against its plain version: the repository's per-dtype
  table (``dtype_tol``: bf16 rtol 2e-2 / atol 2e-1, float32 rtol 2e-5 /
  atol 2e-4). Its bf16 outputs have an RMS of about 1, so atol 0.2 is one
  part in five of a typical element;
- flash attention in bf16: rtol 2e-2 / atol 1e-2. Its outputs at S=2048
  have an RMS of only 0.05-0.1, where the table's atol 0.2 would pass
  almost anything; the kernel's measured bf16 error is 2e-3-4e-3. float32
  takes the table;
- int8 decode attention, dense and paged: float32 takes the table; bf16
  rtol 2e-2 / atol 1e-2, the flash rule, since the outputs' RMS is well
  under 1. A sequence of length 0 must give exact zeros;
- the selective scan: h_last, and float32 y, at rtol 2e-5 / atol 1e-4 (the
  reference's kernel tests). bf16 y at rtol 2e-2 and atol 1e-2 x the RMS of
  the plain y: both sides round one fp32 value to bf16, so they differ by
  at most one bf16 step, 2^-8 of the value;
- whole-model logits and caches: bf16 takes the table elementwise and, in
  the long prefills, a relative L2 error (||got - ref|| / ||ref||) of at
  most 5e-2; float32 takes atol 1e-3 (``atol_scale=50``) because 30 to 64
  layers of reassociated fp32 sums compound;
- every bf16 serve is also held against the plain path run in float32 on
  the served sequence: the kernel path's relative L2 error on the logits,
  and the served logprobs' RMS error, may be at most 1.5 times the plain
  bf16 path's own. For falcon-mamba-7b and hymba-1.5b this gate replaces
  the elementwise bf16 one: the plain bf16 path of those models is itself
  0.3-0.4 away from its float32 self in the largest logit, more than the
  table's atol 0.2, so no bf16 path could pass that. Their float32 serves
  carry the elementwise gate. hymba's long prefill is gated the same way:
  its float32 runs elementwise (atol 1e-3) and by relative L2, its bf16
  runs by their relative L2 error against the plain float32 run, since its
  plain bf16 logits are themselves about 5e-2 (relative L2) from it.

Plain-version float32 matmuls run without TF32 (``allow_tf32=False``), so
they are true fp32.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / fp32 non-tensor
# exp2 on the special-function units: 16 per clock per SM (CUDA programming
# guide, compute capability 9.0) x 132 SMs x the 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9
BATCH, PROMPT, NEW, LONG = 4, 128, 32, 2048
FLASH_BF16_TOL = (2e-2, 1e-2)  # (rtol, atol); see the module docstring
SCAN_F32_TOL = (2e-5, 1e-4)
MAX_REL_L2 = 5e-2
ANCHOR_RATIO = 1.5  # see serve(): bf16 paths held against the float32 plain path
# the scan: falcon-mamba's and hymba's serving prefills, their long prefills, a ragged case, a
# larger state and an odd one
SCAN_SHAPES = [(4, 128, 8192, 16), (4, 128, 3200, 16), (4, LONG, 3200, 16), (4, LONG, 8192, 16),
               (2, 37, 11, 4), (2, 256, 1024, 64), (2, 100, 300, 17)]
# flash attention at the reference zoo's other head dims, at 4 x 2048: (model, Hq, Hkv, D, causal)
FLASH_WIDE = [("hubert-xlarge", 16, 16, 80, False), ("phi3-mini-3.8b", 32, 32, 96, True),
              ("qwen3-0.6b", 16, 8, 128, True)]
# int8 decode attention: (label, (B, Hq, Hkv, S, D), valid lengths); the first is the
# reference's tune-suite shape, then SmolLM-135M's decode at batch 4 and 32 and hymba-1.5b's,
# whose KV ring holds 1024 tokens
DECODE_CELLS = [
    ("tune-suite", (1, 2, 2, 512, 32), (512,)),
    ("smollm-b4", (4, 9, 3, LONG, 64), (LONG, 1000, 0)),
    ("smollm-b32", (32, 9, 3, LONG, 64), (LONG,)),
    ("hymba-b4", (4, 25, 5, 1024, 64), (1024,)),
    ("phi3-b4", (4, 32, 32, LONG, 96), (LONG, 1000)),
]
DECODE_TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-2, 1e-2)}  # dtype_tol; the flash rule
PAGED_SLOTS = 32
# phase 5's cells of the other three kernels, at full width: (kernel, shape, dtype). The masked
# GEMM: SmolLM-135M's decode GEMMs (M = 4), falcon-mamba-7b's widest two, SmolLM's long-prefill
# MLP GEMMs (M = 8192), in bf16 on the fp32 master as kernel mode runs them; float32 v1 at SmolLM's
# decode and at the one-wave M = 512 row. Flash: SmolLM's 4 x 9/3 x 2048^2 and qwen3-0.6b's 16/8 at
# D = 128, causal, hubert-xlarge's 16/16 x 1024^2 at D = 80, not causal; in float32 at D = 64 and 80.
# The scan: falcon-mamba's serving prefill and hymba's long prefill.
TUNE_CELLS = (
    [("masked_matmul", dict(m=4, k=k, n=n, r=256, c=256), "bfloat16")
     for k, n in ((576, 576), (576, 192), (576, 1536), (1536, 576), (4096, 16384), (8192, 4096))]
    + [("masked_matmul", dict(m=8192, k=k, n=n, r=256, c=256), "bfloat16") for k, n in ((576, 1536), (1536, 576))]
    + [("masked_matmul", dict(m=m, k=576, n=n, r=256, c=256), "float32") for m, n in ((4, 1536), (512, 192))]
    + [("flash_attention", dict(b=4, hq=hq, hkv=hkv, sq=s, skv=s, d=d, causal=c), dtype)
       for dtype, cells in (("bfloat16", ((9, 3, LONG, 64, 1), (16, 8, LONG, 128, 1), (16, 16, 1024, 80, 0))),
                            ("float32", ((9, 3, LONG, 64, 1), (16, 16, 1024, 80, 0))))
       for hq, hkv, s, d, c in cells]
    + [("mamba_scan", dict(b=4, l=length, d=d, n=16), "bfloat16") for length, d in ((128, 8192), (LONG, 3200))]
)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


class Failed(Exception):
    pass


def worst(got, ref, tol):
    """(max abs error, whether every element is within tol = (rtol, atol))."""
    rtol, atol = tol
    diff = (got.float() - ref.float()).abs()
    return float(diff.max()), bool((diff <= atol + rtol * ref.float().abs()).all())


def rel_l2(got, ref):
    return float((got.float() - ref.float()).norm() / ref.float().norm())


def reset_launches():
    """Zero the model path's kernel counters: launches and launches by variant
    (the masked GEMM's chip-batched, expert-batched and chip x expert ones
    too, its ``mma`` launches that copied an operand TMA refuses, its
    ``decode`` launches on the offset route, and the
    scan's and its backward's chip-batched ones)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.mamba_scan.ops import selective_scan, selective_scan_bwd
    from repro_torch.kernels.masked_matmul.ops import masked_matmul

    for fn in (masked_matmul, flash_attention, selective_scan, selective_scan_bwd):
        fn.launches = 0
    masked_matmul.copy_launches = masked_matmul.offset_launches = 0
    selective_scan.fleet_launches = selective_scan_bwd.fleet_launches = 0
    for fn, attr in ((masked_matmul, "launches_by_variant"), (masked_matmul, "fleet_launches_by_variant"),
                     (masked_matmul, "expert_launches_by_variant"),
                     (masked_matmul, "fleet_expert_launches_by_variant"), (flash_attention, "launches_by_variant")):
        setattr(fn, attr, dict.fromkeys(getattr(fn, attr), 0))


def variant_counts():
    """Launches by kernel variant since the last ``reset_launches``:
    ``masked_matmul.<v>``, ``masked_matmul.<v>.experts`` (the expert-batched
    ones, counted in the first as well) and ``flash_attention.<v>``."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.masked_matmul.ops import masked_matmul

    got = {f"masked_matmul.{v}": n for v, n in masked_matmul.launches_by_variant.items()}
    got.update({f"masked_matmul.{v}.experts": n for v, n in masked_matmul.expert_launches_by_variant.items()})
    got.update({f"flash_attention.{v}": n for v, n in flash_attention.launches_by_variant.items()})
    return got


# ---------------------------------------------------------------------------
# the program analyses (phases 5, 6, 12 and 13)
# ---------------------------------------------------------------------------

# the archs the stack's analyses lint; falcon-mamba-7b, hymba-1.5b and hubert-xlarge are refused
ANALYSIS_ARCHS = ("internvl2-26b", "llama3-405b", "llama4-maverick-400b-a17b", "mixtral-8x22b",
                  "phi3-mini-3.8b", "qwen3-0.6b", "smollm-135m")
ANALYSIS_REFUSED = ("falcon-mamba-7b", "hymba-1.5b", "hubert-xlarge")
_CPU_DONATION: dict = {}


def cpu_donation_subjects(log=None) -> dict:
    """Each donation entry's carried subjects, kept or rebound, from the
    reduced SmolLM-135M's donation pass on the CPU (``build_stack``'s
    entries): the classification the card's full-width entry points are
    held to. An entry that carries nothing (the population fit) has no
    subject to classify and is not run here; the card runs it."""
    if not _CPU_DONATION:
        import torch

        from repro_torch.analysis import build_stack, lint_donation

        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # tiny tensors: more threads only add their overhead
        seconds = {}
        try:
            for spec in build_stack("smollm-135m", device="cpu").donation_specs:
                t0 = time.perf_counter()
                _CPU_DONATION[spec.name] = lint_donation(spec)[1]["subjects"] if spec.carried else {}
                seconds[spec.name] = round(time.perf_counter() - t0, 3)
        finally:
            torch.set_num_threads(threads)
        if log:
            log(f"the CPU donation run, seconds by entry: {seconds}")
    return _CPU_DONATION


def donation_gate(torch, log, label, specs, gemms):
    """The donation pass over ``specs``, full-width entry points on the card,
    one dispatch each. Every carried subject must be kept or rebound exactly
    as in the CPU run at reduced width, a reused argument (the population
    fit's params0) must keep its storage and bits, and each dispatch must
    make ``gemms[name]`` masked-GEMM kernel launches (the serving
    dispatches' GEMMs go through the kernel; training runs the plain
    product). Returns per entry the carried bytes and the in-place share,
    and the seconds."""
    from repro_torch.analysis import lint_donation
    from repro_torch.kernels.masked_matmul.ops import masked_matmul

    want = cpu_donation_subjects()
    t0 = time.perf_counter()
    out = {}
    for spec in specs:
        before = masked_matmul.launches
        findings, st = lint_donation(spec, min_bytes=1 << 14)
        torch.cuda.synchronize()
        launches = masked_matmul.launches - before
        rebound = sorted(k for k, v in st["subjects"].items() if v == "rebound")
        out[spec.name] = dict(carried_bytes=st["carried_bytes"], donated_bytes=st["donated_bytes"],
                              donated_fraction=st["donated_fraction"], rebound=rebound,
                              findings=sorted(f.key for f in findings), masked_matmul_launches=launches,
                              reused_intact=st["reused_intact"])
        log(f"donation {label} {spec.name}: carried {st['carried_bytes']} bytes, in place "
            f"{st['donated_bytes']} ({st['donated_fraction']:.4f}); {len(st['subjects'])} subjects, rebound "
            f"{rebound if len(rebound) <= 6 else f'{len(rebound)} (every one)'}; masked-GEMM kernel launches "
            f"{launches}" + ("" if st["reused_intact"] is None else f"; params0 intact {st['reused_intact']}"))
        if st["subjects"] != want[spec.name]:
            diff = {k: (st["subjects"].get(k), want[spec.name].get(k))
                    for k in set(st["subjects"]) | set(want[spec.name])
                    if st["subjects"].get(k) != want[spec.name].get(k)}
            raise Failed(f"donation {label} {spec.name}: classified otherwise than the CPU run (card, cpu): {diff}")
        if spec.reused and st["reused_intact"] is not True:
            raise Failed(f"donation {label} {spec.name}: a reused argument lost its storage or its bits")
        if launches != gemms[spec.name]:
            raise Failed(f"donation {label} {spec.name}: {launches} masked-GEMM launches, want {gemms[spec.name]}")
    seconds = time.perf_counter() - t0
    log(f"donation {label}: {seconds:.2f} s")
    return dict(entries=out, seconds=seconds)


# ---------------------------------------------------------------------------
# phase 11: eFAT on the card
# ---------------------------------------------------------------------------

EFAT_CHIPS = 100  # the fleet of examples/fleet_retraining.py
EFAT_PRETRAIN_STEPS = 600  # the example's pretraining
EFAT_PIN_PRETRAIN_STEPS = 300  # tests/test_population.py's pin trainer
EFAT_PIN_RATES = (0.02, 0.08, 0.12, 0.18, 0.22)  # the reference's serial/population pin
EFAT_PIN_BUDGETS = [25, 40, 10]
EFAT_METRIC_TOL = 2e-3
EFAT_TIMED_STEPS = 50  # steps a timed fit takes
EFAT_TIMED_FITS = 5  # timed fits each of population and serial; median and spread
EFAT_EVAL_TIMING_ROUNDS = 3  # the kernel-mode evaluation loops, timed in turns
# the sharded engine against the vmap pin trainer: tests/test_fleet.py's resilience cell
EFAT_SHARDED_RATES = (0.06, 0.14, 0.2)
EFAT_SHARDED_TABLE = dict(array_shape=(32, 32), repeats=2, max_steps=100, seed=5)


def efat_phase(torch, log):
    """eFAT Steps 1-4 and the SIV-C baselines through the port on the card,
    as ``examples/fleet_retraining.py`` runs them, with its gates; returns
    the phase's report and raises ``Failed`` on a missed gate. Turns TF32
    off for float32 matmuls, as ``run`` does, since gate 3 holds the kernel
    to the plain product at ``dtype_tol(float32)``."""
    import gc
    import statistics

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core import (
        EFAT, EFATConfig, correlated_family, from_fault_map, healthy, measure_resilience, periodic_mask,
        random_fault_map,
    )
    from repro_torch.kernels.common import dtype_tol
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.mamba_scan.ops import selective_scan
    from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_ref
    from repro_torch.launch.mesh import make_fleet_mesh, make_pop_mesh
    from repro_torch.launch.sharding import resolve_spec
    from repro_torch.models.classifier import classifier_forward, classifier_param_axes
    from repro_torch.train.fat_trainer import ClassifierFATTrainer
    from repro_torch.train.population import evaluate_metric

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("paper-mlp")
    chips = EFAT_CHIPS
    t_phase = time.perf_counter()
    stages, report = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    # -- gate 1: population against serial, the reference's own pin ----------
    def pin():
        pop = ClassifierFATTrainer(cfg, pretrain_steps=EFAT_PIN_PRETRAIN_STEPS, eval_batches=2)
        ser = ClassifierFATTrainer(cfg, pretrain_steps=0, eval_batches=2, engine="serial")
        ser.base_params = pop.base_params
        ser.baseline_accuracy = ser.evaluate_params(ser.base_params, healthy())
        rng = np.random.default_rng(0)
        fleet5 = [random_fault_map(rng, 32, 32, r) for r in EFAT_PIN_RATES]
        constraint = pop.baseline_accuracy - 0.05
        steps = [tr.steps_to_constraint_batch(fleet5, constraint, 200) for tr in (pop, ser)]
        params = [tr.train_batch(fleet5[:3], EFAT_PIN_BUDGETS) for tr in (pop, ser)]
        metrics = [tr.evaluate_batch(p, fleet5[:3]) for tr, p in zip((pop, ser), params)]
        rtol, atol = dtype_tol(torch.float32, atol_scale=100)
        err, within = 0.0, True
        for a, b in zip(*params):
            for k in a:
                diff = (a[k] - b[k]).abs()
                err = max(err, float(diff.max()))
                within &= bool((diff <= atol + rtol * b[k].abs()).all())
        m_err = max(abs(x - y) for x, y in zip(*metrics))
        log(f"efat pin (5 chips, rates {list(EFAT_PIN_RATES)}, baseline {pop.baseline_accuracy:.4f} - 0.05, "
            f"200 steps): steps population {steps[0]} serial {steps[1]}; train_batch {EFAT_PIN_BUDGETS} max abs "
            f"err {err:.3g} (rtol {rtol}, atol {atol}); metrics {metrics[0]} vs {metrics[1]} (max diff {m_err:.3g}, "
            f"tol {EFAT_METRIC_TOL})")
        if steps[0] != steps[1]:
            raise Failed(f"efat pin: steps-to-constraint population {steps[0]} != serial {steps[1]}")
        if not within:
            raise Failed(f"efat pin: train_batch params differ by {err:.3g} (rtol {rtol}, atol {atol})")
        if m_err > EFAT_METRIC_TOL:
            raise Failed(f"efat pin: metrics differ by {m_err:.3g} > {EFAT_METRIC_TOL}")
        pinned = dict(trainer=pop, fleet5=fleet5, constraint=constraint, steps=steps[0], params=params[0],
                      metrics=metrics[0])
        return dict(steps=steps[0], params_err=err, metric_err=m_err), ser, pinned

    report["pin"], ser, pinned = timed("pin", pin)

    # -- the pipeline of examples/fleet_retraining.py ------------------------
    trainer = timed("pretrain", lambda: ClassifierFATTrainer(cfg, pretrain_steps=EFAT_PRETRAIN_STEPS, eval_batches=4))
    constraint = trainer.baseline_accuracy - 0.03
    fleet = correlated_family(0, chips, 32, 32, base_rate=0.07, idio_rate=0.025, chip_prefix="chip")
    rates = [fm.fault_rate for fm in fleet]
    log(f"efat: pretrained {EFAT_PRETRAIN_STEPS} steps on {trainer.device}, baseline accuracy "
        f"{trainer.baseline_accuracy:.4f}, constraint {constraint:.4f}; fleet {chips} correlated chips, "
        f"rates {min(rates):.3f}..{max(rates):.3f}")
    ef = EFAT(trainer, EFATConfig(
        constraint=constraint, max_fr=0.35, max_interval=0.05, step_ratio=0.6,
        repeats=5, max_steps=400, m_comparisons=8, k_iterations=2, stat="max",
    ))
    table = timed("step1_resilience", lambda: ef.build_resilience_table(fleet))
    for r, mn, mean, mx in zip(table.rates, table.min_steps, table.mean_steps, table.max_steps_stat):
        log(f"efat step 1: rate={r:.3f} -> steps min {mn:.0f} mean {mean:.1f} max {mx:.0f}")
    results = {"eFAT": timed("efat_steps_2_4", lambda: ef.run(fleet))}
    for method, kw in (("individual", {}), ("fixed", dict(steps_per_chip=80)), ("random-merge", {})):
        results[method] = timed(method, lambda: ef.run_baseline(fleet, method, **kw))
    log(f"efat comparison: {'method':14s} {'jobs':>5s} {'total_steps':>12s} {'steps/chip':>11s} {'satisfied':>10s}")
    summaries = {}
    for name, res in results.items():
        s = summaries[name] = res.summary()
        log(f"efat comparison: {name:14s} {s['jobs']:5d} {s['total_steps']:12.0f} "
            f"{s['mean_steps_per_chip']:11.1f} {s['satisfied_fraction']:9.0%}")
    sched = results["eFAT"].scheduling
    log(f"efat scheduler ({sched['policy']}, chunks of {sched['population_size']}): {sched['jobs']} jobs -> "
        f"{sched['chunks']} chunks, wasted lane-steps {sched['wasted_steps']:.0f} (arrival order: "
        f"{sched['arrival_wasted_steps']:.0f}, saved {sched['wasted_steps_reduction']:.0f})")

    # -- gate 2: every shipped weight is exactly 0 on its job's faulty PEs ------
    for name, res in results.items():
        for g, (params, fm) in enumerate(zip(res.job_params, res.plan.fault_maps)):
            ok = torch.as_tensor(fm.ok_mask, device=trainer.device)
            for k, w in params.items():
                if w.dim() == 2 and not torch.equal(w * periodic_mask(w.shape, ok), w):
                    raise Failed(f"efat {name} job {g}: shipped {k} is not zero on the job's faulty PEs")

    # -- gate 3: each chip's deployment through the masked-GEMM kernel ---------
    def deploy():
        efat = results["eFAT"]
        job_of = {chip: g for g, chips_ in enumerate(efat.plan.links) for chip in chips_}
        reset_launches()
        rtol, atol = dtype_tol(torch.float32)
        err, bad, acc_gap, acc_kernel = 0.0, [], 0.0, []
        n_eval = sum(int(b["labels"].numel()) for b in trainer._evals)
        for chip, fm in enumerate(fleet):
            params = efat.job_params[job_of[chip]]
            ctx_k = from_fault_map(fm, "kernel", device=trainer.device)
            ctx_f = from_fault_map(fm, "fap", device=trainer.device)
            hits = [0, 0]
            for b in trainer._evals:
                got = classifier_forward(params, b["x"], cfg, ctx_k)
                ref = classifier_forward(params, b["x"], cfg, ctx_f)
                diff = (got - ref).abs()
                err = max(err, float(diff.max()))
                if not bool((diff <= atol + rtol * ref.abs()).all()):
                    bad.append(chip)
                for i, logits in enumerate((got, ref)):
                    hits[i] += int((logits.argmax(-1) == b["labels"]).sum())
            acc_gap = max(acc_gap, abs(hits[0] - hits[1]) / n_eval)
            acc_kernel.append(hits[0] / n_eval)
        torch.cuda.synchronize()
        v1 = masked_matmul.launches_by_variant["v1"]
        return dict(err=err, bad=bad, acc_gap=acc_gap, n_eval=n_eval, v1=v1, acc_kernel=acc_kernel,
                    launches=dict(masked_matmul=masked_matmul.launches, flash_attention=flash_attention.launches,
                                  selective_scan=selective_scan.launches,
                                  variants=dict(masked_matmul.launches_by_variant)))

    dep = report["deploy"] = timed("deploy", deploy)
    want_v1 = cfg.num_layers * chips * len(trainer._evals)
    log(f"efat deployment: {chips} chips x {len(trainer._evals)} eval batches through classifier_forward in "
        f"kernel mode (masked_matmul v1) against fap mode: logits max abs err {dep['err']:.3g} "
        f"(rtol, atol {dtype_tol(torch.float32)}); accuracy gap {dep['acc_gap']:.3g} (tol 1/{dep['n_eval']}); "
        f"launches {dep['launches']}, v1 {dep['v1']} (want {want_v1})")
    if dep["bad"]:
        raise Failed(f"efat deployment: kernel-mode logits off fap mode on chips {dep['bad'][:10]}")
    if dep["acc_gap"] > 1 / dep["n_eval"]:
        raise Failed(f"efat deployment: kernel-mode accuracy differs from fap by {dep['acc_gap']}")
    if dep["v1"] != want_v1 or dep["launches"]["masked_matmul"] != want_v1:
        raise Failed(f"efat deployment: {dep['launches']} masked-GEMM launches, want {want_v1} v1")

    # -- stage "sharded" (c): the same chips through the population evaluation ---
    shipped = [results["eFAT"].job_params[g] for g, chips_ in enumerate(results["eFAT"].plan.links)
               for _ in chips_]
    order = [chip for chips_ in results["eFAT"].plan.links for chip in chips_]

    def deploy_batched():
        """Every chip's shipped weights in kernel mode through the trainer's
        evaluate_batch (the vmap engine): each masked GEMM one chip-batched
        v1 launch for a chunk of population_size chips."""
        reset_launches()
        got = trainer.evaluate_batch(shipped, [fleet[c] for c in order], mode="kernel")
        torch.cuda.synchronize()
        out = dict(metrics=dict(zip(order, got)), v1=masked_matmul.launches_by_variant["v1"],
                   v1_fleet=masked_matmul.fleet_launches_by_variant["v1"], launches=masked_matmul.launches)
        # the chip-batched kernel at the shapes this path gives it, against its plain version
        gen = torch.Generator(device=trainer.device).manual_seed(0)
        width = trainer.engine.population_size
        ok = torch.stack([torch.as_tensor(fm.ok_mask, dtype=torch.float32, device=trainer.device)
                          for fm in fleet[:width]])
        err, within = 0.0, True
        for i in range(cfg.num_layers):
            w = torch.stack([p[f"w{i}"] for p in shipped[:width]])
            x = torch.randn(width, trainer._evals[0]["x"].shape[0], w.shape[1], generator=gen, device=trainer.device)
            e, wi = worst(masked_matmul(x, w, ok), masked_matmul_ref(x, w, ok), dtype_tol(torch.float32))
            err, within = max(err, e), within and wi
        out.update(parity_err=err, parity_within=within)
        return out

    bat = report["deploy_batched"] = timed("deploy_batched", deploy_batched)
    chunks = -(-chips // trainer.engine.population_size)
    want_batched = cfg.num_layers * len(trainer._evals) * chunks
    gap = max(abs(bat["metrics"][c] - dep["acc_kernel"][c]) for c in range(chips))
    log(f"efat deployment, chip-batched: the same {chips} chips through evaluate_batch(mode='kernel') in "
        f"{chunks} chunks of {trainer.engine.population_size}: accuracy max gap to the serial check {gap:.3g} "
        f"(tol 1/{dep['n_eval']}); v1 launches {bat['v1']}, chip-batched {bat['v1_fleet']} (want {want_batched}, "
        f"against the serial check's {dep['v1']}); the chip-batched v1 at M={trainer._evals[0]['x'].shape[0]} for "
        f"{trainer.engine.population_size} chips against its plain version: max abs err {bat['parity_err']:.3g} "
        f"(rtol, atol {dtype_tol(torch.float32)}); {stages['deploy_batched']:.2f} s against the serial check's "
        f"{stages['deploy']:.2f} s")
    if gap > 1 / dep["n_eval"]:
        raise Failed(f"efat chip-batched deployment: accuracy {gap} off the serial check")
    if not bat["v1"] == bat["v1_fleet"] == bat["launches"] == want_batched:
        raise Failed(f"efat chip-batched deployment: v1 {bat['v1']}, chip-batched {bat['v1_fleet']}, all "
                     f"{bat['launches']}; want {want_batched} chip-batched")
    if not bat["parity_within"]:
        raise Failed(f"efat chip-batched v1 off its plain version by {bat['parity_err']:.3g}")

    # -- the same kernel-mode evaluation alone, one chip at a time and chip-batched ---
    # Timed in turns, launches not counted. The serial check above also runs
    # fap and reads the host four times a batch; deploy_batched also holds
    # the kernel to its plain version. Here each loop does only its own job:
    # "serial forwards" the 1,600 single-chip forwards with no host read,
    # "serial metric" evaluate_metric a chip (one host read a batch), and
    # "chip-batched" evaluate_batch alone.
    def serial_forwards():
        for chip, params in zip(order, shipped):
            ctx = from_fault_map(fleet[chip], "kernel", device=trainer.device)
            for b in trainer._evals:
                classifier_forward(params, b["x"], cfg, ctx)

    def serial_metric():
        for chip, params in zip(order, shipped):
            evaluate_metric(trainer.engine, params, from_fault_map(fleet[chip], "kernel", device=trainer.device))

    def chip_batched():
        trainer.evaluate_batch(shipped, [fleet[c] for c in order], mode="kernel")

    loops = dict(serial_forwards=serial_forwards, serial_metric=serial_metric, chip_batched=chip_batched)
    secs = {name: [] for name in loops}
    for _ in range(EFAT_EVAL_TIMING_ROUNDS):
        for name, fn in loops.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
    report["deploy_timing"] = {name: statistics.median(s) for name, s in secs.items()}
    report["deploy_timing_rounds"] = secs
    log(f"efat deployment alone, median of {EFAT_EVAL_TIMING_ROUNDS} rounds in turns: " + ", ".join(
        f"{name} {t:.4f} s (min {min(secs[name]):.4f} max {max(secs[name]):.4f})"
        for name, t in report["deploy_timing"].items()))

    # -- gate 4: the pipeline's invariant -------------------------------------
    e_steps, i_steps = results["eFAT"].plan.total_steps, results["individual"].plan.total_steps
    log(f"efat: eFAT {results['eFAT'].plan.num_jobs} jobs for {chips} chips, {e_steps:.0f} total steps; "
        f"individual {i_steps:.0f}")
    if e_steps > i_steps:
        raise Failed(f"efat: eFAT's total steps {e_steps} exceed individual's {i_steps}")

    # -- stage "sharded" (a), (b): the sharded engine against the vmap pin trainer ---
    pop_tr, fleet5, c5 = pinned["trainer"], pinned["fleet5"], pinned["constraint"]
    pop_table = measure_resilience(pop_tr, list(EFAT_SHARDED_RATES), c5, **EFAT_SHARDED_TABLE)

    def sharded(mesh):
        tr = ClassifierFATTrainer(cfg, pretrain_steps=0, eval_batches=2, engine="sharded",
                                  engine_kwargs=dict(mesh=mesh))
        tr.base_params = pop_tr.base_params
        steps = tr.steps_to_constraint_batch(fleet5, c5, 200)
        table = measure_resilience(tr, list(EFAT_SHARDED_RATES), c5, **EFAT_SHARDED_TABLE)
        params = tr.train_batch(fleet5[:3], EFAT_PIN_BUDGETS)
        metrics = tr.evaluate_batch(params, fleet5[:3])
        rtol, atol = dtype_tol(torch.float32, atol_scale=100)
        err, within = 0.0, True
        for a, b in zip(params, pinned["params"]):
            for k in a:
                e, w = worst(a[k], b[k], (rtol, atol))
                err, within = max(err, e), within and w
        m_err = max(abs(x - y) for x, y in zip(metrics, pinned["metrics"]))
        same_table = all(np.array_equal(getattr(table, f), getattr(pop_table, f))
                         for f in ("rates", "min_steps", "mean_steps", "max_steps_stat"))
        eng = tr.engine
        out = dict(mesh=dict(eng.mesh.shape), steps=steps, table_equal=same_table, params_err=err,
                   metric_err=m_err, stats=eng.last_fit_stats, width_multiple=tr.scheduler.width_multiple)
        log(f"efat sharded {out['mesh']} (pop extent {eng.num_shards}, model {eng.model_size}, width "
            f"{eng.population_size}) against the vmap pin trainer: steps {steps} vs {pinned['steps']}; resilience "
            f"table equal {same_table} (min {table.min_steps.tolist()} mean {table.mean_steps.tolist()} max "
            f"{table.max_steps_stat.tolist()}); train_batch {EFAT_PIN_BUDGETS} max abs err {err:.3g} (rtol {rtol}, "
            f"atol {atol}); metrics max diff {m_err:.3g} (tol {EFAT_METRIC_TOL}); fit stats {eng.last_fit_stats}")
        if steps != pinned["steps"] or not same_table:
            raise Failed(f"efat sharded {out['mesh']}: steps {steps} / table differ from the vmap engine's")
        if not within or m_err > EFAT_METRIC_TOL:
            raise Failed(f"efat sharded {out['mesh']}: params off by {err:.3g}, metrics by {m_err:.3g}")
        if tr.scheduler.width_multiple != eng.num_shards:
            raise Failed(f"efat sharded: the scheduler tiles {tr.scheduler.width_multiple}, not {eng.num_shards}")
        return out

    report["sharded_pop4"] = timed("sharded_pop4", lambda: sharded(make_pop_mesh(devices=["cuda"] * 4)))
    report["sharded_2x2"] = timed("sharded_2x2", lambda: sharded(make_fleet_mesh(2, 2, devices=["cuda"] * 4)))
    st = report["sharded_2x2"]["stats"]
    limit = st["per_member_total_bytes"] / 2 * 1.05 + 1024
    log(f"efat sharded 2x2: per-member resident bytes at mesh position 0 {st['per_member_resident_bytes']:.0f} "
        f"of {st['per_member_total_bytes']:.0f} (limit {limit:.0f}; one card repeated: the layout and the "
        f"accounting, not a memory saving)")
    if st["model_extent"] != 2 or st["per_member_resident_bytes"] > limit:
        raise Failed(f"efat sharded 2x2: member params not stored split two ways: {st}")

    # -- stage "sharded" (d): compute="sharded", the math on the split pieces, against the pin ---
    def tensor_parallel():
        tr = ClassifierFATTrainer(cfg, pretrain_steps=0, eval_batches=2, engine="sharded", engine_kwargs=dict(
            mesh=make_fleet_mesh(2, 2, devices=["cuda"] * 4), compute="sharded"))
        tr.base_params = pop_tr.base_params
        eng = tr.engine
        steps = tr.steps_to_constraint_batch(fleet5, c5, 200)
        params = tr.train_batch(fleet5[:3], EFAT_PIN_BUDGETS)
        rtol, atol = dtype_tol(torch.float32, atol_scale=100)
        err, within = 0.0, True
        for a, b in zip(params, pinned["params"]):
            for k in a:
                e, w = worst(a[k], b[k], (rtol, atol))
                err, within = max(err, e), within and w
        # the rules' split: every leaf whose spec names "model" is held in model_size pieces
        axes = classifier_param_axes(cfg)
        is_split = {k: "model" in resolve_spec(axes[k], t.shape, eng.mesh_rules) for k, t in params[0].items()}
        split = sum(t.numel() * t.element_size() / (eng.model_size if is_split[k] else 1)
                    for k, t in params[0].items())
        pieces = sum(eng.model_size if is_split[f"w{i}"] else 1 for i in range(cfg.num_layers))
        reset_launches()
        metrics = tr.evaluate_batch(params, fleet5[:3], mode="kernel")
        torch.cuda.synchronize()
        launches = dict(v1=masked_matmul.launches_by_variant["v1"],
                        v1_fleet=masked_matmul.fleet_launches_by_variant["v1"], all=masked_matmul.launches)
        want_v1 = pieces * len(eng.eval_batches) * eng.num_shards * len(list(eng._chunks(3)))
        m_err = max(abs(x - y) for x, y in zip(metrics, pinned["metrics"]))
        st = eng.last_fit_stats
        out = dict(steps=steps, params_err=err, metric_err=m_err, stats=st, split_bytes=split, launches=launches,
                   want_v1=want_v1, pieces_a_forward=pieces)
        log(f"efat sharded 2x2 compute='sharded' (tensor-parallel math, {pieces} GEMM pieces a forward) against the "
            f"vmap pin trainer: steps {steps} vs {pinned['steps']}; train_batch {EFAT_PIN_BUDGETS} max abs err "
            f"{err:.3g} (rtol {rtol}, atol {atol}); kernel-mode metrics max diff {m_err:.3g} (tol {EFAT_METRIC_TOL}); "
            f"v1 launches {launches} (want {want_v1} chip-batched: {pieces} pieces x {len(eng.eval_batches)} eval "
            f"batches x {eng.num_shards} pop slices); per-member resident bytes at mesh position 0 "
            f"{st['per_member_resident_bytes']:.0f} (the rules' split {split:.0f})")
        if steps != pinned["steps"]:
            raise Failed(f"efat sharded compute='sharded': steps {steps} differ from the pin's {pinned['steps']}")
        if not within or m_err > EFAT_METRIC_TOL:
            raise Failed(f"efat sharded compute='sharded': params off by {err:.3g}, metrics by {m_err:.3g}")
        if not launches["v1"] == launches["v1_fleet"] == launches["all"] == want_v1:
            raise Failed(f"efat sharded compute='sharded': launches {launches}, want {want_v1} chip-batched v1")
        if st["per_member_resident_bytes"] != split:
            raise Failed(f"efat sharded compute='sharded': resident bytes {st}, want the rules' split {split}")
        return out

    report["tensor_parallel"] = timed("sharded_tp", tensor_parallel)
    report["sharded_seconds"] = (stages["sharded_pop4"] + stages["sharded_2x2"] + stages["sharded_tp"]
                                 + stages["deploy_batched"])
    log(f"efat stage sharded: {report['sharded_seconds']:.2f} s (pop mesh of 4 {stages['sharded_pop4']:.2f}, 2 x 2 "
        f"{stages['sharded_2x2']:.2f}, 2 x 2 compute='sharded' {stages['sharded_tp']:.2f}, the chip-batched "
        f"deployment check {stages['deploy_batched']:.2f})")

    # -- population steps per second at width 16, against serial ---------------
    def speed_run():
        eng = trainer.engine
        ctxs = [from_fault_map(fm, device=trainer.device) for fm in fleet[:eng.population_size]]
        width = len(ctxs)

        def fit(n):
            return eng.fit_batch(trainer.base_params, ctxs, [n] * width, trainer._train_batch_fn)

        def fit_serial(n):
            return ser.engine.fit_batch(trainer.base_params, ctxs[:1], [n], trainer._train_batch_fn)

        def step_ms(f):
            """Milliseconds a step over EFAT_TIMED_FITS fits of EFAT_TIMED_STEPS
            steps, after a warm fit, a garbage collection and an emptied cache."""
            f(2)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            ms = []
            for _ in range(EFAT_TIMED_FITS):
                t0 = time.perf_counter()
                f(EFAT_TIMED_STEPS)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) / EFAT_TIMED_STEPS * 1e3)
            return ms

        pop_ms, ser_ms = step_ms(fit), step_ms(fit_serial)
        pop, ser_ = statistics.median(pop_ms), statistics.median(ser_ms)
        out = dict(width=width, pop_step_ms_fits=pop_ms, serial_step_ms_fits=ser_ms, pop_step_ms=pop,
                   serial_step_ms=ser_, pop_steps_per_s=1e3 / pop, member_steps_per_s=width * 1e3 / pop,
                   serial_steps_per_s=1e3 / ser_)
        # device ops a population step: the difference of two traced fits (1 and 11 steps)
        from torch.profiler import ProfilerActivity, profile as torch_profile

        traced = []
        for n in (1, 11):
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                fit(n)
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
            traced.append((sum(e.count for e in ev), sum(e.self_device_time_total for e in ev) / 1e3))
        out["device_ops_per_step"] = (traced[1][0] - traced[0][0]) / 10
        out["device_ms_per_step"] = (traced[1][1] - traced[0][1]) / 10
        out["busy_share"] = out["device_ms_per_step"] / pop
        return out

    speed = report["speed"] = timed("timing", speed_run)

    def spread(ms):
        return f"median of {len(ms)} fits, min {min(ms):.3f} max {max(ms):.3f}"

    log(f"efat speed: population width {speed['width']}: {speed['pop_steps_per_s']:.1f} population steps/s "
        f"({speed['pop_step_ms']:.3f} ms a step, {spread(speed['pop_step_ms_fits'])}; "
        f"{speed['member_steps_per_s']:.1f} member steps/s); serial {speed['serial_steps_per_s']:.1f} steps/s "
        f"({speed['serial_step_ms']:.3f} ms, {spread(speed['serial_step_ms_fits'])}); "
        f"{speed['device_ops_per_step']:.1f} kernel launches (device ops) a population step, "
        f"{speed['device_ms_per_step']:.4f} ms device time, busy {speed['busy_share']:.1%} of the untraced "
        "median step")
    seconds = time.perf_counter() - t_phase
    log("efat stages (s): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()) + f"; phase {seconds:.2f} s")
    report.update(
        chips=chips, baseline_accuracy=trainer.baseline_accuracy, constraint=constraint,
        table=json.loads(table.to_json()), summaries=summaries, scheduling=sched, stages=stages,
        seconds=seconds,
    )
    return report


# ---------------------------------------------------------------------------
# phase 12: LM fault-aware training on the card
# ---------------------------------------------------------------------------

LM_CLI_STEPS, LM_RESUME_STEPS = 30, 40  # the CLI run, interrupted at 30 of 40 steps and resumed
LM_PIN_RATES = (0.05, 0.1, 0.2)
LM_PIN_BUDGETS = [5, 8, 3]
LM_PIN_PRETRAIN_STEPS = 0
LM_PIN_F32_MAX_OVER = 10  # float32 pin: elements past atol, each within 2 x lr + atol (Adam's sign-flip step)
LM_METRIC = "loss"  # accuracy stays 0 at vocab 49152 after 150 steps; the mean loss moves
LM_CHIPS = 4  # the population: random_fault_map(i, 256, 256, 0.1), i < 4
LM_MAX_STEPS = 40
LM_TIMED_STEPS = 3  # steps a timed population fit takes
LM_TIMED_FITS = 3
LM_METRIC_TOL = 2e-3
LM_F32_ATOL_SCALE = 50.0  # whole-model float32 logits (the serving gates' rule)
LM_SHARDED_BUDGETS = [4, 2, 4, 1]  # the sharded stage's chips: random_fault_map(c, 256, 256, 0.05 (c + 1))
LM_SERIAL_TOL = 1e-6  # chip-batched kernel-mode metrics against the one-chip-at-a-time loop


# compute="sharded"'s model extent for SmolLM-135M on the card: its 9 query and 3 KV heads divide by
# neither 2 nor 4, so the rules leave wq, wk, wv and wo whole, and at 2 the MLP's and the vocab's
# pieces start on multiples of 256; at 4 the MLP's start at 384 and 1152 (128 mod 256), so the
# rolled maps are exercised
LM_TP_MODEL = 4
LM_TP_GEMMS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.wg", "mlp.wu", "mlp.wd")


def lm_tp_parity(torch, log, cfg, params, oks, engine, m=512, gemms=LM_TP_GEMMS, head="embed"):
    """compute="sharded"'s GEMMs on the card at an LM's layer-0 weights
    ``gemms`` and its unembed (``head``: "embed", the tied unembed read as
    embed.T, or "lm_head") for 2 chips, split as ``engine`` (a sharded engine
    with compute="sharded") stores them, under the maps its chunk builds:
    (a) each weight through ``fault_linear`` in ``kernel`` mode under
    ``torch.func.vmap`` over the chips (the evaluation's path): one
    chip-batched v1 launch a piece, and the joined output against
    ``masked_matmul_ref`` of the whole weight under the whole map, which a
    piece read under another origin's map fails; (b) each piece launched
    alone against ``masked_matmul_ref`` on the same rolled map. At least one
    piece must start off the map's grid. Raises ``Failed``."""
    from repro_torch.core.masking import FaultContext, fault_linear
    from repro_torch.fleet.tensor_parallel import SplitTensor
    from repro_torch.kernels.common import dtype_tol
    from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_ref
    from repro_torch.models import model as M

    specs = M.param_specs(cfg)
    names = [f"layers.0.{n}" for n in gemms] + [head]
    view = engine._slice(0)
    stacked = {k: torch.stack([p[k] for p in params]) for k in names}
    split = view._split({k: specs[k] for k in names}, stacked)
    ok = torch.stack(oks)
    masks = view._constrain_masks(ok, split)
    rows, cols = ok.shape[-2:]
    tol = dtype_tol(torch.float32)
    gen = torch.Generator(device=ok.device).manual_seed(0)
    joined_err, piece_err, origins, launches, bad = 0.0, 0.0, [], {}, []

    def member(x, w, mk):
        return fault_linear(x, w, FaultContext(ok=mk[(0, 0)], mode="kernel", rolled=mk))

    for name in names:
        w, whole = split[name], stacked[name]
        if name == "embed":  # the tied unembed reads embed.T
            w, whole = (w.T if isinstance(w, SplitTensor) else w.transpose(-1, -2)), whole.transpose(-1, -2)
        x = torch.randn(2, m, whole.shape[-2], generator=gen, device=ok.device)
        reset_launches()
        y = torch.func.vmap(member)(x, w, masks)
        torch.cuda.synchronize()
        pieces = len(w.pieces) if isinstance(w, SplitTensor) else 1
        launches[name] = masked_matmul.fleet_launches_by_variant["v1"]
        if not launches[name] == masked_matmul.launches == pieces:
            bad.append(f"{name}: {masked_matmul.launches} launches ({launches[name]} chip-batched v1), want {pieces}")
        e, within = worst(y, masked_matmul_ref(x, whole, ok), tol)
        joined_err = max(joined_err, e)
        if not within:
            bad.append(f"{name}: the joined pieces off the whole weight's GEMM by {e:.3g}")
        for piece, off in zip(*((w.pieces, w.offsets) if isinstance(w, SplitTensor) else ((), ()))):
            r0, c0 = (0, off) if w.axis == -1 else (off, 0)
            key = (r0 % rows, c0 % cols)
            origins.append((name, r0, c0, key))
            xs = x if w.axis == -1 else x[..., off:off + piece.shape[-2]].contiguous()
            e, within = worst(masked_matmul(xs, piece, masks[key]), masked_matmul_ref(xs, piece, masks[key]), tol)
            piece_err = max(piece_err, e)
            if not within:
                bad.append(f"{name} piece at ({r0}, {c0}): off its plain version by {e:.3g}")
    off_grid = [o for o in origins if o[3] != (0, 0)]
    log(f"lm tensor-parallel GEMMs ({cfg.name}: layer 0 and the unembed, 2 chips, M = {m}, float32, model extent "
        f"{engine.model_size}): chip-batched v1 launches {launches}; joined pieces against the whole weight's "
        f"plain GEMM max abs err {joined_err:.3g}, each piece against its plain version on its rolled map "
        f"{piece_err:.3g} (rtol, atol {tol}); {len(origins)} pieces, off the {rows} x {cols} grid: "
        + ", ".join(f"{n} at ({r0}, {c0}) -> roll {k}" for n, r0, c0, k in off_grid))
    if not off_grid:
        bad.append("no piece starts off the map's grid: the rolled maps are not exercised")
    if bad:
        raise Failed("lm tensor-parallel GEMMs: " + "; ".join(bad))
    return dict(joined_err=joined_err, piece_err=piece_err, launches=launches, pieces=len(origins),
                off_grid=[list(o[:3]) for o in off_grid])


# ---------------------------------------------------------------------------
# phase 12, stage "families": FAT of the SSM, hybrid and MoE families
# ---------------------------------------------------------------------------

# depth of each family at its published widths in float32: what one card holds beside the stage's
# copies (PERF.md §4): falcon-mamba-7b 4 of 64 layers, hymba-1.5b 4 of 32, mixtral-8x22b 1 of 56
LM_FAMILY_DEPTH = {"falcon-mamba-7b": 4, "hymba-1.5b": 4, "mixtral-8x22b": 1}
LM_FAMILY_BUDGETS = [2, 3]  # (a): falcon-mamba-7b's 2 chips, random_fault_map(c, 256, 256, 0.05 (c + 1))
LM_FAMILY_GRAD_BL = (2, 64)  # (a): the gradient gate's ssm_block input, batch x length
# (a): the gradient gate's limit, each leaf's largest error over its largest CPU gradient: a sound
# backward reads about 1.6e-06 on the H100, one that reads h_t where h_{t-1} belongs about 0.5
# (tools/planted_faults.py bwd; PERF.md §6)
LM_FAMILY_GRAD_TOL = 1e-5
# (b): hymba-1.5b's compute="sharded" model extent: in_proj's pieces start at 1600, 3200 and 4800 (64, 128
# and 192 mod 256), x_proj's rows at 800 (32 mod 256); its 25 and 5 heads divide by neither 2 nor 4, so
# attention stays whole
LM_FAMILY_TP_MODEL = 4
LM_FAMILY_TP_GEMMS = ("ssm.in_proj", "ssm.x_proj", "ssm.dt_w", "ssm.out_proj", "mlp.wg", "mlp.wu", "mlp.wd")
LM_FAMILY_EXPERT_PIECES = 4  # (c): mixtral-8x22b's 8 experts split 4 ways, 2 a piece
LM_FAMILY_EXPERT_M = 160  # (c): a FAT step's rows an expert: 8 batch rows x capacity 20 (64 tokens, top-2 of 8)
LM_FAMILY_GRAD_REL_L2 = 1e-4  # (c): the member gradient under vmap against plain autograd, each leaf's relative L2


def family_fit_reckoning(copy_bytes: int, members: int) -> int:
    """The population engine's device bytes for a fit of ``members``
    members whose params take ``copy_bytes``, counting whole param copies
    alone: in AdamW's update of a step after the first, ``params0``, the
    members' params and moments (3 copies a member), their gradients (1)
    and the update's new params and moments (3) live at once. It leaves
    out AdamW's temporaries and the backward's activations and masked
    weights, so it undercounts: stage (a) prints its measured peak beside
    it."""
    return copy_bytes * (1 + 7 * members)


def ssm_grad_gate(torch, log, cfg, lp, fm) -> dict:
    """Stage (a)'s gradient gate: the gradient of one ``ssm_block`` (leaves
    ``lp``, at full width) at batch x length ``LM_FAMILY_GRAD_BL``, fap
    under ``fm``, on the card by plain autograd and by ``torch.func.grad``
    (each one forward and one backward scan launch) against the CPU's plain
    autograd. Each leaf's largest error over its largest CPU gradient must
    be at most ``LM_FAMILY_GRAD_TOL``, and no leaf may be zero. Raises
    ``Failed``."""
    from types import SimpleNamespace

    from repro_torch.core import from_fault_map
    from repro_torch.kernels.mamba_scan.ops import selective_scan, selective_scan_bwd
    from repro_torch.models.ssm import ssm_block

    dev = torch.device("cuda")
    cpu_gen = torch.Generator().manual_seed(1)
    b_, l_ = LM_FAMILY_GRAD_BL
    x = torch.randn(b_, l_, cfg.d_model, generator=cpu_gen)
    cot = torch.randn(b_, l_, cfg.d_model, generator=cpu_gen)

    def loss(q, device):
        y, _ = ssm_block(SimpleNamespace(**q), x.to(device), cfg, from_fault_map(fm, "fap", device=device))
        return (y * cot.to(device)).sum()

    def autograd_grads(device):
        q = {k: v.detach().to(device).requires_grad_() for k, v in lp.items()}
        return dict(zip(q, torch.autograd.grad(loss(q, device), list(q.values()))))

    torch.cuda.synchronize()
    before = selective_scan.launches, selective_scan_bwd.launches
    t0 = time.perf_counter()
    g_cpu = autograd_grads("cpu")
    g_card = {"autograd": autograd_grads(dev),
              "torch.func.grad": torch.func.grad(lambda q: loss(q, dev))({k: v.detach() for k, v in lp.items()})}
    torch.cuda.synchronize()
    route = (selective_scan.launches - before[0], selective_scan_bwd.launches - before[1])
    seconds = time.perf_counter() - t0
    grad_err, bad = {}, []
    for how, g in g_card.items():
        for k in lp:
            scale = float(g_cpu[k].abs().max())
            e = float((g[k].cpu() - g_cpu[k]).abs().max()) / scale
            grad_err[f"{how} {k}"] = e
            if not e <= LM_FAMILY_GRAD_TOL or not float(g[k].abs().max()) > 0:
                bad.append(f"{how} {k}: max err {e:.3g} of its largest gradient {scale:.3g}")
    top = max(grad_err, key=grad_err.get)
    log(f"lm families (a) gradient gate: layer 0's ssm_block at B x L = {b_} x {l_}, full width, fap, its gradient "
        f"on the card (plain autograd and torch.func.grad) against the CPU's, each leaf's largest error over its "
        f"largest CPU gradient: at most {grad_err[top]:.3g} ({top}; limit {LM_FAMILY_GRAD_TOL}) over {len(lp)} "
        f"leaves, each non-zero: {not bad}; scan launches forward and backward {route}, want (2, 2)")
    if bad or route != (2, 2):
        raise Failed(f"lm families (a) gradient gate: {bad}; forward and backward scan launches {route}, want (2, 2)")
    return dict(grad_err=grad_err[top], grad_err_leaf=top, grad_leaves=len(lp), grad_seconds=seconds)


def lm_families(torch, log):
    """Stage "families" of phase 12: fault-aware training of the SSM, hybrid
    and MoE families through the port's entry points, at published widths in
    float32 (depths ``LM_FAMILY_DEPTH``), chips ``random_fault_map(c, 256,
    256, 0.05 (c + 1))``. Returns the stage's report; raises ``Failed`` on a
    missed gate.

    (a) falcon-mamba-7b, 2 chips at LM_FAMILY_BUDGETS: the population engine
    against the serial one (the float32 pin rule); in the fits a forward
    and a backward scan kernel a layer a step (chip-batched in the
    population's), no GEMM launch; ``ssm_grad_gate``; the backward kernel
    at the population fit's launch against its plain version, timed; then
    ``kernel``-mode evaluation, every scan and GEMM chip-batched, held to
    ``fap`` and to one chip at a time. (b) hymba-1.5b under
    ``compute="sharded"`` on 2 x LM_FAMILY_TP_MODEL against the vmap engine
    (the pin rule; the untied embedding's elements each within its limit,
    and at most the serial engine's count from the same vmap run plus the
    pin's own 10: the lookup table's near-zero gradients flip Adam's first
    steps on float noise, the reference's serial protocol too), the fits'
    forward and backward scans (one chip-batched pair a channel piece a
    step), resident bytes the rules' split, the split GEMMs against
    the whole weight (``lm_tp_parity``) and the chip-batched scan a channel
    piece against its plain version, then ``kernel``-mode evaluation: one
    chip-batched scan a channel piece, one chip-batched v1 a weight piece.
    (c) mixtral-8x22b: its experts split LM_FAMILY_EXPERT_PIECES ways for 2
    chips, a chips x experts launch a piece joined against the whole
    stack's launch and each piece against its plain version; the
    population engine's fit is not run: ``family_fit_reckoning`` puts it
    over the card's memory, and the reckoning undercounts ((a) prints by
    how much); its member gradient, the router
    under ``vmap`` and ``grad``, against plain autograd."""
    from repro_torch.configs import get_arch
    from repro_torch.core import MASKABLE_KEYS, from_fault_map
    from repro_torch.core.masking import FaultContext, fault_einsum
    from repro_torch.fleet.tensor_parallel import SplitTensor
    from repro_torch.kernels.common import dtype_tol
    from repro_torch.kernels.mamba_scan.ops import (
        selective_scan, selective_scan_bwd, selective_scan_bwd_ref, selective_scan_ref,
    )
    from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_ref
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.launch.sharding import resolve_spec
    from repro_torch.models import model as M
    from repro_torch.train.fat_trainer import LMFATTrainer
    from repro_torch.train.population import evaluate_metric

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = dtype_tol(torch.float32)
    rtol, atol = dtype_tol(torch.float32, atol_scale=100)
    gen = torch.Generator(device=dev).manual_seed(0)
    report, stages = {}, {}

    def family(name):
        return dataclasses.replace(get_arch(name), num_layers=LM_FAMILY_DEPTH[name], dtype="float32",
                                   param_dtype="float32")

    def chips(n):
        from repro_torch.core import random_fault_map

        return [random_fault_map(c, 256, 256, 0.05 * (c + 1)) for c in range(n)]

    def okt(fm):
        return torch.as_tensor(fm.ok_mask, dtype=torch.float32, device=dev)

    def pin(got, want, lr):
        """The float32 pin rule: (max abs err, elements past rtol/atol, the
        limit each may reach, the leaves that hold them with their counts)."""
        err, over, where = 0.0, 0, {}
        for a, b in zip(got, want):
            for k in a:
                diff = (a[k].double() - b[k].double()).abs()
                err = max(err, float(diff.max()))
                n = int((diff > atol + rtol * b[k].double().abs()).sum())
                over += n
                if n:
                    where[k] = where.get(k, 0) + n
        return err, over, 2 * lr + atol, where

    def check_pin(what, err, over, limit, where):
        if over > LM_PIN_F32_MAX_OVER or err > limit:
            raise Failed(f"lm families {what}: train_batch params differ by {err:.3g} (limit {limit:.3g}), {over} "
                         f"elements over (limit {LM_PIN_F32_MAX_OVER}), by leaf {where}")

    def launches():
        torch.cuda.synchronize()
        return dict(scan=selective_scan.launches, scan_fleet=selective_scan.fleet_launches,
                    bwd=selective_scan_bwd.launches, bwd_fleet=selective_scan_bwd.fleet_launches,
                    gemm=masked_matmul.launches, v1=masked_matmul.launches_by_variant["v1"],
                    v1_fleet=masked_matmul.fleet_launches_by_variant["v1"])

    def metrics_gate(what, m_k, m_f, m_s):
        f_err = max(abs(x - y) for x, y in zip(m_k, m_f))
        s_err = max(abs(x - y) for x, y in zip(m_k, m_s))
        if f_err > LM_METRIC_TOL or s_err > LM_SERIAL_TOL:
            raise Failed(f"lm families {what}: kernel-mode metrics {m_k}, fap {m_f} (tol {LM_METRIC_TOL}), one chip "
                         f"at a time {m_s} (tol {LM_SERIAL_TOL})")
        return f_err, s_err

    def slice_steps(trainer, budgets):
        """Steps each pop slice runs (its members' largest budget, in the
        order the trainer's scheduler hands them to the engine), summed."""
        budgets = trainer.scheduler.schedule(budgets).permute(budgets)
        k = len(budgets) // trainer.engine.num_shards
        return sum(max(budgets[d * k:(d + 1) * k]) for d in range(trainer.engine.num_shards))

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # -- (a) falcon-mamba-7b: the population and serial engines, the scan's backward kernel ---
    def ssm_fat():
        cfg = family("falcon-mamba-7b")
        layers, fleet = cfg.num_layers, chips(2)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pop = LMFATTrainer(cfg, pretrain_steps=0, metric=LM_METRIC, population_size=len(fleet))
        ser = LMFATTrainer(cfg, pretrain_steps=0, metric=LM_METRIC, engine="serial")
        ser.base_params = pop.base_params
        seconds = dict(init=time.perf_counter() - t0)
        copy = sum(t.numel() * t.element_size() for t in pop.base_params.values())
        reckon = family_fit_reckoning(copy, len(fleet))
        reset_launches()
        t0 = time.perf_counter()
        got = pop.train_batch(fleet, LM_FAMILY_BUDGETS)
        fit_launches = launches()
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        reset_launches()
        t0 = time.perf_counter()
        want = ser.train_batch(fleet, LM_FAMILY_BUDGETS)
        ser_launches = launches()
        seconds["serial_fit"] = time.perf_counter() - t0
        err, over, limit, where = pin(got, want, pop.opt_cfg.learning_rate)
        # a forward and a backward scan a layer a step: one chip-batched pair for the population's
        # members, one pair a member-step for the serial engine; no masked GEMM launch (fap)
        n_pop, n_ser = layers * max(LM_FAMILY_BUDGETS), layers * sum(LM_FAMILY_BUDGETS)
        want_pop = dict(scan=n_pop, scan_fleet=n_pop, bwd=n_pop, bwd_fleet=n_pop, gemm=0, v1=0, v1_fleet=0)
        want_ser = dict(scan=n_ser, scan_fleet=0, bwd=n_ser, bwd_fleet=0, gemm=0, v1=0, v1_fleet=0)
        log(f"lm families (a) {cfg.name} (depth {layers}, float32, {len(fleet)} chips, budgets {LM_FAMILY_BUDGETS}): "
            f"population against serial max abs err {err:.3g} (limit {limit:.3g}), {over} elements over (rtol "
            f"{rtol}, atol {atol}; limit {LM_PIN_F32_MAX_OVER}; by leaf {where}); population fit {fit_s:.2f} s, serial "
            f"fit {seconds['serial_fit']:.2f} s; the population fit's peak {peak / 1e9:.2f} GB over the stage's start "
            f"against family_fit_reckoning's {reckon / 1e9:.2f} GB (a param copy {copy / 1e9:.3f} GB x "
            f"{reckon // copy}; measured / reckoned {peak / reckon:.3f}); launches in the population fit {fit_launches} "
            f"(want {want_pop}), in the serial fit {ser_launches} (want {want_ser})")
        if fit_launches != want_pop or ser_launches != want_ser:
            raise Failed(f"lm families (a): the fits launched {fit_launches} and {ser_launches}, want {want_pop} and "
                         f"{want_ser}")
        check_pin("(a)", err, over, limit, where)
        out = dict(fit_seconds=fit_s, params_err=err, elements_over_tol=over, peak_bytes=peak,
                   reckoned_bytes=reckon, copy_bytes=copy, fit_launches=fit_launches, serial_launches=ser_launches)
        del ser, want
        free()

        # the gradient gate: one ssm_block on the card against the CPU, every SSM leaf
        lp = {k.rsplit(".", 1)[-1]: v for k, v in pop.base_params.items() if k.startswith("layers.0.ssm.")}
        out.update(ssm_grad_gate(torch, log, cfg, lp, fleet[0]))
        seconds["gradient_gate"] = out["grad_seconds"]
        free()

        # the backward kernel at the population fit's launch against its plain version, timed
        rows, length = len(fleet) * pop.stream.batch_size, pop.stream.seq_len
        dim, n = cfg.d_inner, cfg.ssm_state
        u, gy = torch.randn(2, rows, length, dim, generator=gen, device=dev)
        dt = torch.nn.functional.softplus(torch.randn(rows, length, dim, generator=gen, device=dev) - 3)
        a = -torch.exp(torch.randn(len(fleet), dim, n, generator=gen, device=dev))
        bm, cm = torch.randn(2, rows, length, n, generator=gen, device=dev)
        d_skip = torch.randn(len(fleet), dim, generator=gen, device=dev)
        gh = torch.randn(rows, dim, n, generator=gen, device=dev)
        args = (u, dt, a, bm, cm, d_skip, gy, gh)
        before = selective_scan_bwd.fleet_launches
        grads = selective_scan_bwd(*args)
        torch.cuda.synchronize()
        ran = selective_scan_bwd.fleet_launches - before
        ref = selective_scan_bwd_ref(*args)
        bwd_err = {}
        for name_, g_, r_ in zip(("gu", "gdt", "ga", "gb", "gc", "gd"), grads, ref):
            scale = max(float(r_.abs().max()), 1.0)  # gA, gB and gC sum over B x L or D
            bwd_err[name_] = worst(g_ / scale, r_ / scale, SCAN_F32_TOL)
        del grads, ref
        elems = rows * length * dim * n
        nbytes = 4 * (4 * rows * length * dim + 4 * rows * length * n + 2 * len(fleet) * (dim * n + dim)
                      + rows * length * dim + rows * dim * n)
        # the bound: each input read and each output written once at the HBM rate, or 18 fp32 operations
        # per (b, t, d, n) at the fp32 rate (the state, dh, the four gradient terms), or its one
        # exponential on the SFUs, whichever takes longest
        sides = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": 18 * elems / PEAK_OPS["float32"] * 1e3,
                 "exps": elems / SFU_PER_S * 1e3}
        flush = torch.empty(2**28, dtype=torch.int32, device=dev)
        row = dict(ms=event_ms(torch, lambda: selective_scan_bwd(*args), flush),
                   plain_ms=event_ms(torch, lambda: selective_scan_bwd_ref(*args), flush, 3),
                   bound_ms=max(sides.values()), bound_by="bytes" if sides["bytes"] >= max(sides.values()) else
                   "operations", sides_ms=sides, max_abs_err=max(e for e, _ in bwd_err.values()),
                   shape=[len(fleet), rows // len(fleet), length, dim, n])
        del flush, args, u, gy, dt, bm, cm, gh
        log(f"lm families (a) selective_scan_bwd at the population fit's launch ({len(fleet)} chips x "
            f"{rows // len(fleet)} x {length} x {dim} x {n}, float32, gh given; {card_line()}): {ran} chip-batched "
            f"launch; against its plain version, each gradient in units of its largest plain value, max err "
            + ", ".join(f"{k} {e:.3g}" for k, (e, _) in bwd_err.items())
            + f" (rtol, atol {SCAN_F32_TOL}); kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms (bytes {sides['bytes']:.4f}, 18 fp32 ops/elem {sides['operations']:.4f}, "
            f"exps {sides['exps']:.4f})")
        if ran != 1 or not all(ok_ for _, ok_ in bwd_err.values()):
            raise Failed(f"lm families (a): selective_scan_bwd ran {ran} chip-batched launches (want 1), errors {bwd_err}")
        out["bwd_row"] = row

        # kernel-mode evaluation: every scan and GEMM chip-batched
        per_forward = sum(uses for _, _, uses in cfg.gemm_shapes())
        t0 = time.perf_counter()
        reset_launches()
        m_k = pop.evaluate_batch(got, fleet, mode="kernel")
        ran = launches()
        want_ran = dict(scan=layers * len(pop._evals), gemm=per_forward * len(pop._evals))
        m_f = pop.evaluate_batch(got, fleet)
        m_s = [evaluate_metric(pop.engine, p, from_fault_map(fm, "kernel", device=dev)) for p, fm in zip(got, fleet)]
        f_err, s_err = metrics_gate("(a)", m_k, m_f, m_s)
        seconds["deployment"] = time.perf_counter() - t0
        log(f"lm families (a) deployment (kernel mode, evaluate_batch): launches {ran}, want {want_ran} all "
            f"chip-batched; {LM_METRIC} {[round(-v, 6) for v in m_k]}, against fap max diff {f_err:.3g}, against one "
            f"chip at a time {s_err:.3g}; seconds " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
        if not (ran["scan"] == ran["scan_fleet"] == want_ran["scan"] and ran["bwd"] == 0
                and ran["gemm"] == ran["v1"] == ran["v1_fleet"] == want_ran["gemm"]):
            raise Failed(f"lm families (a) deployment: launches {ran}, want {want_ran} chip-batched")
        out.update(eval_launches=ran, metrics_kernel=m_k, fap_err=f_err, serial_err=s_err, seconds=seconds)
        return out

    # -- (b) hymba-1.5b under compute="sharded", against the vmap engine ------------------
    def hybrid_tp():
        cfg = family("hymba-1.5b")
        layers, fleet = cfg.num_layers, chips(len(LM_SHARDED_BUDGETS))
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        vm = LMFATTrainer(cfg, pretrain_steps=0, metric=LM_METRIC)
        tp = LMFATTrainer(cfg, pretrain_steps=0, metric=LM_METRIC, engine="sharded", engine_kwargs=dict(
            mesh=make_fleet_mesh(2, LM_FAMILY_TP_MODEL, devices=["cuda"] * 2 * LM_FAMILY_TP_MODEL),
            compute="sharded"))
        tp.base_params = vm.base_params
        eng = tp.engine
        reset_launches()
        t0 = time.perf_counter()
        got = tp.train_batch(fleet, LM_SHARDED_BUDGETS)
        tp_launches = launches()
        fit_s = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        want = vm.train_batch(fleet, LM_SHARDED_BUDGETS)
        vm_launches = launches()
        vmap_fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        err, over, limit, where = pin(got, want, tp.opt_cfg.learning_rate)
        # the untied embedding's departure beside the serial engine's (the reference's protocol) from the
        # same vmap run: Adam moves a row element by +-lr on a near-zero lookup gradient's sign
        ser = LMFATTrainer(cfg, pretrain_steps=0, metric=LM_METRIC, engine="serial")
        ser.base_params = vm.base_params
        s_err, s_over, _, s_where = pin(ser.train_batch(fleet, LM_SHARDED_BUDGETS), want, tp.opt_cfg.learning_rate)
        del ser
        over_rest = over - where.get("embed", 0)
        embed_limit = s_where.get("embed", 0) + LM_PIN_F32_MAX_OVER
        specs = M.param_specs(cfg)

        def n_pieces(k):
            return eng.model_size if "model" in resolve_spec(specs[k], got[0][k].shape, eng.mesh_rules) else 1

        st = eng.last_fit_stats
        split = sum(t.numel() * t.element_size() / n_pieces(k) for k, t in got[0].items())
        # a forward and a backward scan a layer a channel piece a pop slice's step, chip-batched over the
        # slice's members; the vmap engine's a layer a step
        n_tp, n_vm = layers * LM_FAMILY_TP_MODEL * slice_steps(tp, LM_SHARDED_BUDGETS), layers * max(LM_SHARDED_BUDGETS)
        want_tp = dict(scan=n_tp, scan_fleet=n_tp, bwd=n_tp, bwd_fleet=n_tp, gemm=0, v1=0, v1_fleet=0)
        want_vm = dict(scan=n_vm, scan_fleet=n_vm, bwd=n_vm, bwd_fleet=n_vm, gemm=0, v1=0, v1_fleet=0)
        log(f"lm families (b) {cfg.name} (depth {layers}, float32, {len(fleet)} chips, budgets {LM_SHARDED_BUDGETS}) "
            f"compute='sharded' on {dict(eng.mesh.shape)} against the vmap engine: max abs err {err:.3g} (limit "
            f"{limit:.3g}), {over} elements over (by leaf {where}; limit {LM_PIN_F32_MAX_OVER} but the untied "
            f"embedding's, each within the limit and at most {embed_limit} of them, the serial engine's count plus "
            f"{LM_PIN_F32_MAX_OVER}; the serial engine against the same vmap run: max abs err {s_err:.3g}, {s_over} "
            f"over, by leaf {s_where}); fit {fit_s:.2f} s against the vmap engine's {vmap_fit_s:.2f} s; per-member "
            f"resident bytes at mesh position 0 {st['per_member_resident_bytes']:.0f} of "
            f"{st['per_member_total_bytes']:.0f} (the rules' split: {split:.0f}); launches in the split fit "
            f"{tp_launches} (want {want_tp}), in the vmap fit {vm_launches} (want {want_vm}); peak {peak / 1e9:.2f} GB")
        if tp_launches != want_tp or vm_launches != want_vm:
            raise Failed(f"lm families (b): the fits launched {tp_launches} and {vm_launches}, want {want_tp} and "
                         f"{want_vm}")
        check_pin("(b)", err, over_rest, limit, where)
        if where.get("embed", 0) > embed_limit:
            raise Failed(f"lm families (b): {where['embed']} elements of the untied embedding past the pin, over the "
                         f"serial engine's {s_where.get('embed', 0)} + {LM_PIN_F32_MAX_OVER}")
        if (st["pop_extent"], st["model_extent"]) != (2, LM_FAMILY_TP_MODEL) or st["per_member_resident_bytes"] != split:
            raise Failed(f"lm families (b): member state not stored as the rules split it: {st}, want {split}")
        out = dict(fit_seconds=fit_s, vmap_fit_seconds=vmap_fit_s, params_err=err, elements_over_tol=over,
                   over_by_leaf=where, serial_err=s_err, serial_over_by_leaf=s_where, embed_limit=embed_limit,
                   stats=st, split_bytes=split, fit_launches=tp_launches, vmap_launches=vm_launches, peak_bytes=peak)
        del want
        free()

        # the split GEMMs (lm_tp_parity) and the chip-batched scan a channel piece, 2 chips
        oks = [okt(fm) for fm in fleet[:2]]
        out["parity"] = lm_tp_parity(torch, log, cfg, got[:2], oks, eng, gemms=LM_FAMILY_TP_GEMMS, head="lm_head")
        apart = 1 + 0.1 * torch.arange(2, dtype=torch.float32, device=dev)  # chip 1's A and D set apart
        a_all = -torch.exp(torch.stack([p["layers.0.ssm.a_log"] for p in got[:2]]).float()) * apart[:, None, None]
        d_all = torch.stack([p["layers.0.ssm.d_skip"] for p in got[:2]]) * apart[:, None]
        width, n = cfg.d_inner // LM_FAMILY_TP_MODEL, cfg.ssm_state
        rows = 2 * tp.stream.batch_size
        scan_err, scan_ran = 0.0, 0
        for o in range(0, cfg.d_inner, width):
            u = torch.randn(rows, tp.stream.seq_len, width, generator=gen, device=dev)
            dt = torch.nn.functional.softplus(torch.randn(rows, tp.stream.seq_len, width, generator=gen, device=dev) - 3)
            bm, cm = torch.randn(2, rows, tp.stream.seq_len, n, generator=gen, device=dev)
            args = (u, dt, a_all[:, o:o + width].contiguous(), bm, cm, d_all[:, o:o + width].contiguous())
            before = selective_scan.fleet_launches
            y, h = selective_scan(*args)
            scan_ran += selective_scan.fleet_launches - before
            ref_y, ref_h = selective_scan_ref(*args)
            for got_t, ref_t in ((y, ref_y), (h, ref_h)):
                e, within = worst(got_t, ref_t, SCAN_F32_TOL)
                scan_err = max(scan_err, e)
                if not within:
                    raise Failed(f"lm families (b): the chip-batched scan of the channel piece at {o} off its plain "
                                 f"version by {e:.3g} (tol {SCAN_F32_TOL})")
        log(f"lm families (b) chip-batched scan a channel piece (2 chips x {rows // 2} x {tp.stream.seq_len} x "
            f"{width} x {n}, each chip's own A and D, {cfg.d_inner // width} pieces): {scan_ran} launches, max abs err "
            f"{scan_err:.3g} against the plain version (tol {SCAN_F32_TOL})")
        if scan_ran != cfg.d_inner // width:
            raise Failed(f"lm families (b): {scan_ran} chip-batched scan launches, want {cfg.d_inner // width}")
        out.update(scan_piece_err=scan_err)

        # kernel-mode evaluation on the split pieces
        pieces = sum(n_pieces(k) for k in got[0] if k.rsplit(".", 1)[-1] in MASKABLE_KEYS)
        reset_launches()
        m_k = tp.evaluate_batch(got, fleet, mode="kernel")
        ran = launches()
        evals = len(tp._evals) * eng.num_shards
        want_ran = dict(scan=layers * LM_FAMILY_TP_MODEL * evals, gemm=pieces * evals)
        m_f = vm.evaluate_batch(got, fleet)
        m_s = [evaluate_metric(tp.engine, p, from_fault_map(fm, "kernel", device=dev)) for p, fm in zip(got, fleet)]
        f_err, s_err = metrics_gate("(b)", m_k, m_f, m_s)
        log(f"lm families (b) deployment (kernel mode through the split forward): launches {ran}, want {want_ran} all "
            f"chip-batched ({pieces} GEMM pieces and {layers * LM_FAMILY_TP_MODEL} channel pieces a forward x "
            f"{len(tp._evals)} eval batches x {eng.num_shards} pop slices); {LM_METRIC} against fap max diff "
            f"{f_err:.3g}, against one chip at a time {s_err:.3g}")
        if not (ran["scan"] == ran["scan_fleet"] == want_ran["scan"]
                and ran["gemm"] == ran["v1"] == ran["v1_fleet"] == want_ran["gemm"]):
            raise Failed(f"lm families (b) deployment: launches {ran}, want {want_ran} chip-batched")
        out.update(eval_launches=ran, pieces_a_forward=pieces, metrics_kernel=m_k, fap_err=f_err, serial_err=s_err)
        return out

    # -- (c) mixtral-8x22b: the expert split's parity; the router under vmap and grad ------
    def moe_fat():
        cfg = family("mixtral-8x22b")
        fleet = chips(2)
        ok = torch.stack([okt(fm) for fm in fleet])
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tr = LMFATTrainer(cfg, pretrain_steps=0, metric=LM_METRIC, population_size=1)
        params = tr.base_params
        out = dict(expert_split={})

        def member(spec):
            return lambda x, w, mk: fault_einsum(spec, x, w, FaultContext(ok=mk, mode="kernel"))

        for wname, spec in (("wg", "ecd,edf->ecf"), ("wu", "ecd,edf->ecf"), ("wd", "ecf,efd->ecd")):
            w = params[f"layers.0.moe.{wname}"]
            w2 = torch.stack([w, 2 * w])  # chip 1's experts x 2: a read of the other chip's shows
            e, k_ = w.shape[:2]
            step = e // LM_FAMILY_EXPERT_PIECES
            offsets = list(range(0, e, step))
            split = SplitTensor([w2[:, o:o + step].contiguous() for o in offsets], -3, offsets)
            x = torch.randn(2, e, LM_FAMILY_EXPERT_M, k_, generator=gen, device=dev)
            reset_launches()
            y_split = torch.func.vmap(member(spec))(x, split, ok)
            n_split = launches()["gemm"], masked_matmul.fleet_expert_launches_by_variant["v1"]
            reset_launches()
            y_whole = torch.func.vmap(member(spec))(x, w2, ok)
            n_whole = launches()["gemm"], masked_matmul.fleet_expert_launches_by_variant["v1"]
            joined, j_ok = worst(y_split, y_whole, f32)
            del y_split, y_whole
            piece_err = 0.0
            for piece, o in zip(split.pieces, offsets):
                xs = x[:, o:o + step].contiguous()
                e_, p_ok = worst(masked_matmul(xs, piece, ok), masked_matmul_ref(xs, piece, ok), f32)
                piece_err = max(piece_err, e_)
                j_ok = j_ok and p_ok
            out["expert_split"][wname] = dict(launches=n_split, whole_launches=n_whole, joined_err=joined,
                                              piece_err=piece_err)
            log(f"lm families (c) {cfg.name} {wname} ({spec}, 2 chips x {e} experts x M {LM_FAMILY_EXPERT_M} x "
                f"{tuple(w.shape[1:])}, split {LM_FAMILY_EXPERT_PIECES} ways over the experts): (launches, chips x "
                f"experts v1) {n_split} for the pieces, {n_whole} for the whole stack; joined against the whole "
                f"stack's launch max abs err {joined:.3g}, each piece against its plain version {piece_err:.3g} "
                f"(rtol, atol {f32})")
            if n_split != (LM_FAMILY_EXPERT_PIECES,) * 2 or n_whole != (1, 1) or not j_ok:
                raise Failed(f"lm families (c) {wname}: launches {n_split} (want {LM_FAMILY_EXPERT_PIECES} chips x "
                             f"experts v1) and {n_whole} (want 1), joined err {joined:.3g}, piece err {piece_err:.3g}")
            del w2, split, x
            free()

        copy = sum(t.numel() * t.element_size() for t in params.values())
        reckon = family_fit_reckoning(copy, 1)
        total = torch.cuda.mem_get_info()[1]
        under = report["ssm"]["peak_bytes"] / report["ssm"]["reckoned_bytes"]
        out.update(copy_bytes=copy, reckoned_bytes=reckon, card_bytes=total)
        if reckon <= total:
            raise Failed(f"lm families (c): the fit is reckoned at {reckon / 1e9:.2f} GB, within the card's "
                         f"{total / 1e9:.2f} GB: run it")
        # the population engine's member gradient, its own transform on one member: the fit's
        # forward and backward without the update's copies
        eng = tr.engine
        batch = tr._train_batch_fn(0)
        members = {k: v[None] for k, v in params.items()}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        grads, (value, _) = torch.func.vmap(lambda p, mk: eng._grad(p, batch, eng._ctx(mk, "fap")))(members, ok[:1])
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        q = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, _ = eng.loss_fn(q, batch, from_fault_map(fleet[0], "fap", device=dev))
        ref = dict(zip(q, torch.autograd.grad(loss, list(q.values()))))
        errs = {k: rel_l2(grads[k][0], ref[k]) for k in q if float(ref[k].norm()) > 0}
        zero = [k for k in q if not float(grads[k][0].abs().max()) > 0]
        worst_k = max(errs, key=errs.get)
        out.update(grad_seconds=grad_s, grad_peak_bytes=peak, loss=float(value[0]), loss_autograd=float(loss.detach()),
                   grad_rel_l2=errs[worst_k], zero_grads=zero)
        log(f"lm families (c) {cfg.name} (depth {cfg.num_layers}, float32): the population engine's fit at width 1 "
            f"reckoned at {reckon / 1e9:.2f} GB (a param copy {copy / 1e9:.2f} GB x {reckon // copy}; the reckoning "
            f"undercounts, (a)'s measured peak was {under:.3f} x its reckoning) against the card's {total / 1e9:.2f} "
            f"GB (fits: {reckon <= total}); its member gradient (vmap of grad_and_value, the router "
            f"included) in {grad_s:.2f} s, peak {peak / 1e9:.2f} GB over the stage's start; loss "
            f"{float(value[0]):.6f} against plain autograd's {float(loss.detach()):.6f}; gradients' relative L2 against plain "
            f"autograd at most {errs[worst_k]:.3g} ({worst_k}; limit {LM_FAMILY_GRAD_REL_L2}); zero gradients {zero}")
        if zero or errs[worst_k] > LM_FAMILY_GRAD_REL_L2 or abs(float(value[0]) - float(loss.detach())) > f32[1]:
            raise Failed(f"lm families (c): the member gradient off plain autograd: {out}")
        return out

    for name, fn in (("ssm", ssm_fat), ("hybrid_tp", hybrid_tp), ("moe", moe_fat)):
        t0 = time.perf_counter()
        report[name] = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        free()
    report.update(stages=stages, seconds=sum(stages.values()),
                  bwd_launches=sum(report[k][f]["bwd"] for k, f in (
                      ("ssm", "fit_launches"), ("ssm", "serial_launches"), ("hybrid_tp", "fit_launches"),
                      ("hybrid_tp", "vmap_launches"))))
    log("lm stage families: " + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items())
        + f"; {report['seconds']:.2f} s")
    return report


def lm_phase(torch, log):
    """Fault-aware training of SmolLM-135M at full width through the port's
    entry points, with its gates; returns the phase's report and raises
    ``Failed`` on a missed gate.

    (a) the training CLI for 40 steps with checkpoints every 10, interrupted
    after 30 as a preemption would stop it, the same command run again to
    resume, and the result held to a straight 40-step run; (b)
    ``LMFATTrainer`` on both engines (the serial/population pin), in float64
    and float32; (c) the trainer at the reference's defaults in bf16
    (pretraining 150 steps, population 4) with the mean loss as its metric,
    steps-to-constraint and FAT for 4 chips, the constraint halfway between
    the healthy loss and the least-hurt chip's, so every chip trains; (d) each chip's trained weights
    through the card kernels (``kernel`` mode) against ``fap`` mode, and a
    4 x 2048 ``loss_fn`` through the masked GEMM and flash; (e) the
    population step's time, device ops and busy share, peak memory."""
    import shutil
    import statistics

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core import MASKABLE_KEYS, from_fault_map, random_fault_map
    from repro_torch.data import TokenStream
    from repro_torch.kernels.common import dtype_tol
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_ref
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.launch.sharding import resolve_spec
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import step as step_lib
    from repro_torch.train.fat_trainer import LMFATTrainer
    from repro_torch.train.population import evaluate_metric

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("smollm-135m")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    per_forward = sum(uses for _, _, uses in cfg.gemm_shapes())
    t_phase = time.perf_counter()
    stages, report = {}, {}
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by the phases before this one

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    def params_err(a, b, rtol, atol):
        err, ok = 0.0, True
        for k in a:
            e, w = worst(a[k], b[k], (rtol, atol))
            err, ok = max(err, e), ok and w
        return err, ok

    # -- (a) the CLI: 40 steps interrupted at 30, run again, against a straight run ---
    def interrupt_at(n, seen):
        """The CLI's train step, made to stop the run as a preemption would
        once the optimizer has taken ``n`` steps; ``seen`` collects each
        call's (optimizer count, loss), so a retried step shows."""
        make = step_lib.make_jit_train_step

        def make_stoppable(*args, **kw):
            step = make(*args, **kw)

            def stoppable(p, o, b, ctx):
                count = int(o["count"])
                if count == n:
                    raise KeyboardInterrupt
                p, o, metrics = step(p, o, b, ctx)
                seen.append((count, float(metrics["loss"])))
                return p, o, metrics

            return stoppable

        return make_stoppable

    def cli():
        ckpt = OUT_DIR / "lm_ckpt"
        shutil.rmtree(ckpt, ignore_errors=True)
        argv = ["--arch", cfg.name, "--steps", str(LM_RESUME_STEPS), "--batch", "8", "--seq", "64",
                "--fault-rate", "0.1", "--ckpt-every", "10", "--eval-every", "10"]
        make, seen = step_lib.make_jit_train_step, []
        step_lib.make_jit_train_step = interrupt_at(LM_CLI_STEPS, seen)
        try:
            train_cli.main(argv + ["--ckpt-dir", str(ckpt)])
            raise Failed(f"lm cli: the run was not interrupted at step {LM_CLI_STEPS}")
        except KeyboardInterrupt:
            pass
        finally:
            step_lib.make_jit_train_step = make
        stopped_at = ckpt_lib.latest_step(str(ckpt))
        if stopped_at != LM_CLI_STEPS or [c for c, _ in seen] != list(range(LM_CLI_STEPS)):
            raise Failed(f"lm cli: interrupted at {LM_CLI_STEPS}, latest checkpoint {stopped_at}, "
                         f"optimizer counts {[c for c, _ in seen]}")
        resumed, _, second = train_cli.main(argv + ["--ckpt-dir", str(ckpt)])
        straight, _, third = train_cli.main(argv)
        shutil.rmtree(ckpt, ignore_errors=True)
        rtol, atol = dtype_tol(torch.float32, atol_scale=100)
        err, ok = params_err(resumed, straight, rtol, atol)
        losses = [x for _, x in seen] + [m["loss"] for st in (second, third) for _, m in st.metrics_history
                                         if "loss" in m]
        step_ms = statistics.median(third.step_times) * 1e3
        out = dict(resume_err=err, resume_within=ok, restarts=[st.restarts for st in (second, third)],
                   losses=losses, steps=[stopped_at, second.step, third.step],
                   resumed_steps=len(second.step_times), step_ms=step_ms,
                   steps_per_s=1e3 / step_ms, stragglers=len(third.straggler_events))
        log(f"lm cli: {LM_RESUME_STEPS} steps interrupted at {stopped_at} (its latest checkpoint; each of its steps "
            f"ran once), the same "
            f"command run again ({out['resumed_steps']} steps), against a straight {LM_RESUME_STEPS}-step run: "
            f"params max abs err {err:.3g} (rtol {rtol}, atol {atol}); restarts "
            f"{out['restarts']}; {len(losses)} losses, all finite: {all(math.isfinite(x) for x in losses)} (the first "
            f"{losses[0]:.4f}, the last {losses[-1]:.4f}); straight run {out['steps_per_s']:.2f} "
            f"train steps/s (median step {step_ms:.2f} ms, host clock, card synchronized), stragglers "
            f"{out['stragglers']}")
        if not ok:
            raise Failed(f"lm cli: resumed params differ from the straight run by {err:.3g}")
        if any(out["restarts"]) or not all(math.isfinite(x) for x in losses):
            raise Failed(f"lm cli: restarts {out['restarts']}, losses {losses}")
        if out["steps"] != [LM_CLI_STEPS, LM_RESUME_STEPS, LM_RESUME_STEPS] or \
                out["resumed_steps"] != LM_RESUME_STEPS - LM_CLI_STEPS:
            raise Failed(f"lm cli: ran {out['steps']} steps, {out['resumed_steps']} after the resume")
        return out

    report["cli"] = timed("cli", cli)

    # -- (b) the pin: population against serial, in float64 and float32 ---------
    def pin():
        rng = np.random.default_rng(0)
        fleet3 = [random_fault_map(rng, 256, 256, r) for r in LM_PIN_RATES]
        rtol, atol = dtype_tol(torch.float32, atol_scale=100)
        out = {}
        for dt in ("float64", "float32"):  # the float32 trainer is kept for (d)
            c = dataclasses.replace(cfg, dtype=dt, param_dtype=dt)
            pop = LMFATTrainer(c, pretrain_steps=LM_PIN_PRETRAIN_STEPS, metric=LM_METRIC)
            ser = LMFATTrainer(c, pretrain_steps=0, engine="serial", metric=LM_METRIC)
            ser.base_params = pop.base_params
            params = [tr.train_batch(fleet3, LM_PIN_BUDGETS) for tr in (pop, ser)]
            metrics = [tr.evaluate_batch(p, fleet3) for tr, p in zip((pop, ser), params)]
            err, over = 0.0, 0
            for a, b in zip(*params):
                for k in a:
                    diff = (a[k].double() - b[k].double()).abs()
                    err = max(err, float(diff.max()))
                    over += int((diff > atol + rtol * b[k].double().abs()).sum())
            m_err = max(abs(x - y) for x, y in zip(*metrics))
            # float64: every element within tolerance. float32: the two engines' first gradients
            # differ in sign on a few noise-level elements, and Adam turns each into a step of
            # up to lr either way, so a few may land up to 2 x lr + atol apart
            max_over, max_err = (0, math.inf) if dt == "float64" else \
                (LM_PIN_F32_MAX_OVER, 2 * pop.opt_cfg.learning_rate + atol)
            out[dt] = dict(params_err=err, elements_over_tol=over, metric_err=m_err, metrics=metrics[0],
                           max_over=max_over, max_err=max_err)
            log(f"lm pin ({dt}, 3 chips, rates {list(LM_PIN_RATES)}, budgets {LM_PIN_BUDGETS}): train_batch "
                f"population against serial max abs err {err:.3g} (limit {max_err:.3g}), {over} of "
                f"{sum(t.numel() for t in params[0][0].values()) * len(fleet3)} elements over (rtol {rtol}, atol "
                f"{atol}; limit {max_over}); {LM_METRIC} {[round(-x, 5) for x in metrics[0]]} vs "
                f"{[round(-x, 5) for x in metrics[1]]} (max diff {m_err:.3g}, tol {LM_METRIC_TOL})")
            if m_err > LM_METRIC_TOL:
                raise Failed(f"lm pin {dt}: metrics differ by {m_err:.3g}")
            if over > max_over or err > max_err:
                raise Failed(f"lm pin {dt}: train_batch params differ by {err:.3g}, {over} elements over")
            del ser, params
        return out, pop

    report["pin"], trainer32 = timed("pin", pin)

    # -- (c) the main path in bf16 at the reference's defaults, the loss as metric ---
    trainer = timed("pretrain", lambda: LMFATTrainer(cfg, metric=LM_METRIC))
    fleet = [random_fault_map(i, 256, 256, 0.1) for i in range(LM_CHIPS)]

    def fat():
        # signed metrics (the loss negated): higher is better
        before = trainer.evaluate_batch([trainer.base_params] * LM_CHIPS, fleet)
        gap = trainer.baseline_metric - max(before)
        if not gap > 0:
            raise Failed(f"lm fat: the faults did not raise the loss: healthy {-trainer.baseline_metric:.5f}, "
                         f"faulty {[round(-x, 5) for x in before]}")
        constraint = trainer.baseline_metric - gap / 2  # no chip meets it before FAT
        steps = trainer.steps_to_constraint_batch(fleet, constraint, LM_MAX_STEPS)
        if not all(s is None or s > 0 for s in steps):
            raise Failed(f"lm fat: steps {steps} against a constraint no chip met before FAT")
        trained = trainer.train_batch(fleet, [LM_MAX_STEPS if s is None else s for s in steps])
        after = trainer.evaluate_batch(trained, fleet)
        return constraint, steps, before, after, trained

    constraint, steps, before, after, trained = timed("fat", fat)
    log(f"lm fat (bf16, pretrained 150 steps, healthy loss {-trainer.baseline_metric:.5f}, constraint loss "
        f"{-constraint:.5f}, halfway to the least-hurt chip, {LM_MAX_STEPS} steps at most): steps {steps}; loss "
        f"faulty before FAT {[round(-x, 5) for x in before]}, after {[round(-x, 5) for x in after]}")
    report["fat"] = dict(metric=LM_METRIC, baseline=-trainer.baseline_metric, constraint=-constraint, steps=steps,
                         before=[-x for x in before], after=[-x for x in after])

    # -- the donation pass: one train step and one population fit, in fap mode as (c) trains ---
    def donation():
        from repro_torch.analysis.programs import population_spec, train_step_spec
        from repro_torch.train.optimizer import adamw_init

        ctxs = [from_fault_map(fm, "fap", device=trainer.device) for fm in fleet]
        step = step_lib.make_jit_train_step(cfg, trainer.opt_cfg, remat="none")
        params = dict(trainer.base_params)
        specs = [train_step_spec(step, params, adamw_init(params, trainer.opt_cfg), trainer._train_batch_fn(0),
                                 ctxs[0]),
                 population_spec(trainer.engine, trainer.base_params, torch.stack([c.ok for c in ctxs]),
                                 [1] * LM_CHIPS, trainer._train_batch_fn)]
        return donation_gate(torch, log, "phase 12", specs, {"train.step": 0, "population.fit_run": 0})

    report["donation"] = timed("donation", donation)

    # -- (d) deployment through the card kernels ------------------------------------
    main_path = {"masked_matmul": {}, "flash_attention": {}}  # every kernel-mode run's launches

    def counts():
        torch.cuda.synchronize()
        got = dict(masked_matmul=dict(masked_matmul.launches_by_variant),
                   flash_attention=dict(flash_attention.launches_by_variant))
        for kernel, by_variant in got.items():
            for variant, n in by_variant.items():
                main_path[kernel][variant] = main_path[kernel].get(variant, 0) + n
        return got

    def check_counts(what, got, forwards, gemm, flash=None):
        want_mm = {k: (per_forward * forwards if k == gemm else 0) for k in got["masked_matmul"]}
        want_fa = {k: (cfg.num_layers * forwards if k == flash else 0) for k in got["flash_attention"]}
        if got["masked_matmul"] != want_mm or got["flash_attention"] != want_fa:
            raise Failed(f"lm deploy {what}: launches {got}, want {want_mm} and {want_fa}")

    def deploy():
        out = {}
        f32_atol = dtype_tol(torch.float32, atol_scale=LM_F32_ATOL_SCALE)
        for c, tr in ((cfg, trainer), (cfg32, trainer32)):
            dt = c.dtype
            err_max, ratio, forwards = 0.0, 0.0, 0
            reset_launches()
            with torch.no_grad():
                for params, fm in zip(trained, fleet):
                    ctx_k = from_fault_map(fm, "kernel", device=trainer.device)
                    ctx_f = from_fault_map(fm, "fap", device=trainer.device)
                    for b in tr._evals:
                        got = M.forward(params, b, c, ctx_k)[0]
                        forwards += 1
                        ref = M.forward(params, b, c, ctx_f)[0]
                        if dt == "bfloat16":
                            anchor = M.forward(params, b, cfg32, ctx_f)[0]
                            r = rel_l2(got, anchor) / max(rel_l2(ref, anchor), 1e-12)
                            ratio = max(ratio, r)
                            err_max = max(err_max, rel_l2(got, anchor))
                        else:
                            e, w = worst(got, ref, f32_atol)
                            err_max = max(err_max, e)
                            if not w:
                                raise Failed(f"lm deploy float32: kernel-mode logits off fap by {e:.3g}")
            gemm = "mma" if dt == "bfloat16" else "v1"
            launches = counts()
            check_counts(f"{dt} eval", launches, forwards, gemm)
            if dt == "bfloat16" and ratio > ANCHOR_RATIO:
                raise Failed(f"lm deploy bf16: kernel path {ratio:.3f}x the plain bf16 path's error")
            reset_launches()
            m_k = [evaluate_metric(tr.engine, p, from_fault_map(fm, "kernel", device=trainer.device))
                   for p, fm in zip(trained, fleet)]
            m_launches = counts()
            check_counts(f"{dt} evaluate_metric", m_launches, LM_CHIPS * len(tr._evals), gemm)
            m_f = tr.evaluate_batch(trained, fleet)
            m_err = max(abs(x - y) for x, y in zip(m_k, m_f))
            if m_err > LM_METRIC_TOL:
                raise Failed(f"lm deploy {dt}: kernel-mode metrics {m_k} vs fap {m_f}")
            out[dt] = dict(worst=err_max, anchor_ratio=ratio, forwards=forwards, launches=launches,
                           metrics_kernel=m_k, metrics_fap=m_f, metric_err=m_err,
                           evaluate_launches=m_launches)
            log(f"lm deploy {dt}: {LM_CHIPS} chips x {len(tr._evals)} eval batches, kernel mode against fap: "
                + (f"relative L2 to plain float32 {err_max:.3g}, {ratio:.3f}x the plain bf16 path's (limit "
                   f"{ANCHOR_RATIO})" if dt == "bfloat16" else f"logits max abs err {err_max:.3g} (rtol, atol "
                   f"{f32_atol})")
                + f"; {LM_METRIC} kernel {[round(-x, 5) for x in m_k]} fap {[round(-x, 5) for x in m_f]} (max diff "
                f"{m_err:.3g}); launches {launches['masked_matmul']} ({per_forward} a forward)")
        # one 4 x 2048 loss through the masked GEMM and flash against fap with dense attention
        long_batch = TokenStream(cfg.vocab_size, 2048, 4, seed=0, device=trainer.device).batch_at(10_000_000)
        ctx_k = from_fault_map(fleet[0], "kernel", device=trainer.device)
        ctx_f = from_fault_map(fleet[0], "fap", device=trainer.device)
        params = trained[0]
        with torch.no_grad():
            anchor = M.forward(params, long_batch, cfg32, ctx_f, attn_impl="dense")[0]
            for c in (cfg, cfg32):
                dt = c.dtype
                variant = "mma" if dt == "bfloat16" else "v1"  # of both kernels
                reset_launches()
                got = M.forward(params, long_batch, c, ctx_k, attn_impl="kernel")[0]
                loss_k, met_k = M.loss_fn(params, long_batch, c, ctx_k, attn_impl="kernel")
                launches = counts()
                check_counts(f"{dt} 4x2048", launches, 2, variant, variant)
                ref = M.forward(params, long_batch, c, ctx_f, attn_impl="dense")[0]
                loss_f, met_f = M.loss_fn(params, long_batch, c, ctx_f, attn_impl="dense")
                row = dict(loss_kernel=float(loss_k), loss_fap=float(loss_f), acc_kernel=float(met_k["accuracy"]),
                           acc_fap=float(met_f["accuracy"]), launches=launches)
                if dt == "bfloat16":
                    r = rel_l2(got, anchor) / max(rel_l2(ref, anchor), 1e-12)
                    row.update(rel_l2=rel_l2(got, anchor), plain_rel_l2=rel_l2(ref, anchor), anchor_ratio=r)
                    bad = r > ANCHOR_RATIO
                else:
                    e, w = worst(got, ref, dtype_tol(torch.float32, atol_scale=LM_F32_ATOL_SCALE))
                    row.update(err=e)
                    bad = not w
                acc_gap = abs(row["acc_kernel"] - row["acc_fap"])
                loss_gap = abs(row["loss_kernel"] - row["loss_fap"])
                log(f"lm long loss {dt} (4x2048, kernel mode + flash against fap + dense attention): loss "
                    f"{row['loss_kernel']:.5f} vs {row['loss_fap']:.5f}, accuracy {row['acc_kernel']:.5f} vs "
                    f"{row['acc_fap']:.5f}; " + (f"relative L2 to plain float32 {row['rel_l2']:.3g}, "
                    f"{r:.3f}x the plain bf16 path's" if dt == "bfloat16" else f"logits max abs err {e:.3g}")
                    + f"; launches {launches}")
                if bad or acc_gap > LM_METRIC_TOL or loss_gap > LM_METRIC_TOL:
                    raise Failed(f"lm long loss {dt}: kernel path off the plain path: {row}")
                out[f"long_{dt}"] = row
                del got, ref
        out["launches"] = main_path
        return out

    report["deploy"] = timed("deploy", deploy)

    # -- stage "sharded": the sharded engine on a 2 x 2 mesh, float32, against the vmap engine ---
    def sharded():
        fleet4 = [random_fault_map(c, 256, 256, 0.05 * (c + 1)) for c in range(len(LM_SHARDED_BUDGETS))]
        shd = LMFATTrainer(cfg32, pretrain_steps=0, metric=LM_METRIC, engine="sharded",
                           engine_kwargs=dict(mesh=make_fleet_mesh(2, 2, devices=["cuda"] * 4)))
        shd.base_params = trainer32.base_params = trainer.base_params
        t0 = time.perf_counter()
        got = shd.train_batch(fleet4, LM_SHARDED_BUDGETS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        want = trainer32.train_batch(fleet4, LM_SHARDED_BUDGETS)
        rtol, atol = dtype_tol(torch.float32, atol_scale=100)
        max_err = 2 * trainer32.opt_cfg.learning_rate + atol
        err, over = 0.0, 0
        for a, b in zip(got, want):
            for k in a:
                diff = (a[k].double() - b[k].double()).abs()
                err = max(err, float(diff.max()))
                over += int((diff > atol + rtol * b[k].double().abs()).sum())
        eng = shd.engine
        st = eng.last_fit_stats
        # the bytes mesh position 0 holds when every leaf the rules split is stored in two pieces
        specs = M.param_specs(cfg32)
        split = sum(t.numel() * t.element_size() / (2 if "model" in resolve_spec(specs[k], t.shape, eng.mesh_rules)
                                                    else 1) for k, t in got[0].items())
        out = dict(fit_seconds=fit_s, params_err=err, elements_over_tol=over, stats=st, split_bytes=split)
        log(f"lm sharded (float32, {LM_SHARDED_BUDGETS} steps, mesh {dict(eng.mesh.shape)}, width "
            f"{eng.population_size}): train_batch against the vmap engine max abs err {err:.3g} (limit "
            f"{max_err:.3g}), {over} elements over (rtol {rtol}, atol {atol}; limit {LM_PIN_F32_MAX_OVER}); fit "
            f"{fit_s:.2f} s; per-member resident bytes at mesh position 0 {st['per_member_resident_bytes']:.0f} of "
            f"{st['per_member_total_bytes']:.0f} (the rules' split: {split:.0f}; one card repeated: the layout "
            f"and the accounting, not a memory saving)")
        if over > LM_PIN_F32_MAX_OVER or err > max_err:
            raise Failed(f"lm sharded: train_batch params differ by {err:.3g}, {over} elements over")
        if (st["pop_extent"], st["model_extent"]) != (2, 2) or st["per_member_resident_bytes"] != split \
                or not split < st["per_member_total_bytes"]:
            raise Failed(f"lm sharded: member state not stored split two ways: {st}, want {split}")
        # (e) kernel mode: each pop slice's forward one chip-batched launch a GEMM
        reset_launches()
        m_k = shd.evaluate_batch(got, fleet4, mode="kernel")
        torch.cuda.synchronize()
        out["launches"] = dict(v1=masked_matmul.launches_by_variant["v1"],
                               v1_fleet=masked_matmul.fleet_launches_by_variant["v1"], all=masked_matmul.launches)
        m_f = shd.evaluate_batch(got, fleet4)
        m_s = [evaluate_metric(shd.engine, p, from_fault_map(fm, "kernel", device=trainer.device))
               for p, fm in zip(got, fleet4)]
        # the chip-batched v1 at this path's shapes (a pop slice's 2 chips, M = 8 x 64) against its plain version
        gen = torch.Generator(device=trainer.device).manual_seed(0)
        ok = torch.stack([torch.as_tensor(fm.ok_mask, dtype=torch.float32, device=trainer.device)
                          for fm in fleet4[:2]])
        perr, pwithin = 0.0, True
        weights = [f"layers.0.{n}" for n in ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.wg", "mlp.wu",
                                             "mlp.wd")]
        for name in weights + ["embed"]:
            w = torch.stack([p[name] for p in got[:2]])
            w = w.transpose(-1, -2) if name == "embed" else w  # the tied unembed reads embed.T
            x = torch.randn(2, shd._evals[0]["tokens"].numel(), w.shape[1], generator=gen, device=trainer.device)
            e, wi = worst(masked_matmul(x, w, ok), masked_matmul_ref(x, w, ok), dtype_tol(torch.float32))
            perr, pwithin = max(perr, e), pwithin and wi
        want_v1 = per_forward * len(shd._evals) * eng.num_shards
        f_err = max(abs(x - y) for x, y in zip(m_k, m_f))
        s_err = max(abs(x - y) for x, y in zip(m_k, m_s))
        out.update(metrics_kernel=m_k, metrics_fap=m_f, metrics_serial=m_s, fap_err=f_err, serial_err=s_err,
                   parity_err=perr, parity_within=pwithin, want_v1=want_v1)
        log(f"lm sharded deployment (kernel mode through the sharded evaluate_batch): v1 launches "
            f"{out['launches']} (want {want_v1} chip-batched: {per_forward} a forward x {len(shd._evals)} eval "
            f"batches x {eng.num_shards} pop slices); {LM_METRIC} {[round(-x, 6) for x in m_k]}, against fap max "
            f"diff {f_err:.3g} (tol {LM_METRIC_TOL}), against one chip at a time {s_err:.3g} (tol "
            f"{LM_SERIAL_TOL}); the chip-batched v1 for 2 chips at M = 512 against its plain version: max abs "
            f"err {perr:.3g} (rtol, atol {dtype_tol(torch.float32)})")
        if not out["launches"]["v1"] == out["launches"]["v1_fleet"] == out["launches"]["all"] == want_v1:
            raise Failed(f"lm sharded deployment: launches {out['launches']}, want {want_v1} chip-batched v1")
        if f_err > LM_METRIC_TOL or s_err > LM_SERIAL_TOL:
            raise Failed(f"lm sharded deployment: kernel metrics {m_k}, fap {m_f}, one chip at a time {m_s}")
        if not pwithin:
            raise Failed(f"lm sharded: the chip-batched v1 off its plain version by {perr:.3g}")
        tp_inputs.update(fleet4=fleet4, got=got, want=want, m_f=m_f, m_s=m_s, fit_s=fit_s)
        return out

    tp_inputs: dict = {}
    report["sharded"] = timed("sharded", sharded)

    # -- stage "sharded", compute="sharded": the math on the split pieces, on a 2 x LM_TP_MODEL mesh ---
    def tensor_parallel():
        fleet4, got, want = tp_inputs["fleet4"], tp_inputs["got"], tp_inputs["want"]
        tp = LMFATTrainer(cfg32, pretrain_steps=0, metric=LM_METRIC, engine="sharded", engine_kwargs=dict(
            mesh=make_fleet_mesh(2, LM_TP_MODEL, devices=["cuda"] * 2 * LM_TP_MODEL), compute="sharded"))
        tp.base_params = trainer.base_params
        eng = tp.engine
        oks = [torch.as_tensor(fm.ok_mask, dtype=torch.float32, device=trainer.device) for fm in fleet4[:2]]
        out = dict(parity=lm_tp_parity(torch, log, cfg32, got[:2], oks, eng))
        # the gathered run's trained chips in kernel mode through the split forward
        specs = M.param_specs(cfg32)

        def n_pieces(k):
            return eng.model_size if "model" in resolve_spec(specs[k], got[0][k].shape, eng.mesh_rules) else 1

        pieces = sum(n_pieces(k) for k in got[0] if k.split(".")[-1] in MASKABLE_KEYS) + n_pieces("embed")
        reset_launches()
        m_k = tp.evaluate_batch(got, fleet4, mode="kernel")
        torch.cuda.synchronize()
        launches = dict(v1=masked_matmul.launches_by_variant["v1"],
                        v1_fleet=masked_matmul.fleet_launches_by_variant["v1"], all=masked_matmul.launches)
        want_v1 = pieces * len(tp._evals) * eng.num_shards
        f_err = max(abs(x - y) for x, y in zip(m_k, tp_inputs["m_f"]))
        s_err = max(abs(x - y) for x, y in zip(m_k, tp_inputs["m_s"]))
        log(f"lm sharded compute='sharded' deployment (mesh {dict(eng.mesh.shape)}): v1 launches {launches} (want "
            f"{want_v1} chip-batched: {pieces} pieces a forward x {len(tp._evals)} eval batches x {eng.num_shards} "
            f"pop slices); {LM_METRIC} against fap max diff {f_err:.3g} (tol {LM_METRIC_TOL}), against one chip at a "
            f"time {s_err:.3g} (tol {LM_SERIAL_TOL})")
        if not launches["v1"] == launches["v1_fleet"] == launches["all"] == want_v1:
            raise Failed(f"lm sharded compute='sharded': launches {launches}, want {want_v1} chip-batched v1")
        if f_err > LM_METRIC_TOL or s_err > LM_SERIAL_TOL:
            raise Failed(f"lm sharded compute='sharded': kernel metrics {m_k}, fap {tp_inputs['m_f']}, "
                         f"one chip at a time {tp_inputs['m_s']}")
        # training, held to the vmap engine's fit by the float32 pin rule
        t0 = time.perf_counter()
        got_tp = tp.train_batch(fleet4, LM_SHARDED_BUDGETS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        rtol, atol = dtype_tol(torch.float32, atol_scale=100)
        max_err = 2 * trainer32.opt_cfg.learning_rate + atol
        err, over = 0.0, 0
        for a, b in zip(got_tp, want):
            for k in a:
                diff = (a[k].double() - b[k].double()).abs()
                err = max(err, float(diff.max()))
                over += int((diff > atol + rtol * b[k].double().abs()).sum())
        st = eng.last_fit_stats
        split = sum(t.numel() * t.element_size() / n_pieces(k) for k, t in got_tp[0].items())
        out.update(launches=launches, want_v1=want_v1, pieces_a_forward=pieces, metrics_kernel=m_k, fap_err=f_err,
                   serial_err=s_err, params_err=err, elements_over_tol=over, stats=st, split_bytes=split,
                   fit_seconds=fit_s, gathered_fit_seconds=tp_inputs["fit_s"])
        log(f"lm sharded compute='sharded' (float32, {LM_SHARDED_BUDGETS} steps, mesh {dict(eng.mesh.shape)}): "
            f"train_batch against the vmap engine max abs err {err:.3g} (limit {max_err:.3g}), {over} elements over "
            f"(rtol {rtol}, atol {atol}; limit {LM_PIN_F32_MAX_OVER}); fit {fit_s:.2f} s against the gathered 2 x 2 "
            f"run's {tp_inputs['fit_s']:.2f} s; per-member resident bytes at mesh position 0 "
            f"{st['per_member_resident_bytes']:.0f} of {st['per_member_total_bytes']:.0f} (the rules' split: "
            f"{split:.0f})")
        if over > LM_PIN_F32_MAX_OVER or err > max_err:
            raise Failed(f"lm sharded compute='sharded': train_batch params differ by {err:.3g}, {over} elements over")
        if (st["pop_extent"], st["model_extent"]) != (2, LM_TP_MODEL) or st["per_member_resident_bytes"] != split:
            raise Failed(f"lm sharded compute='sharded': member state not stored as the rules split it: {st}, "
                         f"want {split}")
        return out

    report["tensor_parallel"] = timed("sharded_tp", tensor_parallel)
    tp_inputs.clear()
    log(f"lm stage sharded: {stages['sharded'] + stages['sharded_tp']:.2f} s (gathered 2 x 2 "
        f"{stages['sharded']:.2f}, compute='sharded' 2 x {LM_TP_MODEL} {stages['sharded_tp']:.2f})")

    # -- (e) the population step: time, device ops, busy share --------------------
    def speed():
        eng = trainer.engine
        ctxs = [from_fault_map(fm, device=trainer.device) for fm in fleet]

        def fit(n):
            return eng.fit_batch(trainer.base_params, ctxs, [n] * len(ctxs), trainer._train_batch_fn)

        fit(1)
        gc.collect()
        torch.cuda.synchronize()
        ms = []
        for _ in range(LM_TIMED_FITS):
            t0 = time.perf_counter()
            fit(LM_TIMED_STEPS)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) / LM_TIMED_STEPS * 1e3)
        from torch.profiler import ProfilerActivity, profile as torch_profile

        traced = []
        for n in (1, 3):
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                fit(n)
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
            traced.append((sum(e.count for e in ev), sum(e.self_device_time_total for e in ev) / 1e3))
        step = statistics.median(ms)
        out = dict(width=len(ctxs), step_ms_fits=ms, step_ms=step, member_steps_per_s=len(ctxs) * 1e3 / step,
                   device_ops_per_step=(traced[1][0] - traced[0][0]) / 2,
                   device_ms_per_step=(traced[1][1] - traced[0][1]) / 2)
        out["busy_share"] = out["device_ms_per_step"] / step
        log(f"lm speed: population width {len(ctxs)}: {step:.2f} ms a population step (median of {LM_TIMED_FITS} "
            f"fits of {LM_TIMED_STEPS}, min {min(ms):.2f} max {max(ms):.2f}), {out['member_steps_per_s']:.1f} member "
            f"steps/s; {out['device_ops_per_step']:.1f} device ops a step, {out['device_ms_per_step']:.3f} ms device "
            f"time, busy {out['busy_share']:.1%} of the untraced median step")
        return out

    report["speed"] = timed("timing", speed)
    report["peak_memory_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    del trainer, trainer32, trained
    gc.collect()
    torch.cuda.empty_cache()
    # stage "families": the SSM, hybrid and MoE families (it reads its own peaks)
    report["families"] = timed("families", lambda: lm_families(torch, log))
    seconds = time.perf_counter() - t_phase
    log(f"lm peak device memory {report['peak_memory_gib']:.2f} GiB over the {held / 2**30:.2f} GiB held "
        "when the phase began; stages (s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()) + f"; phase {seconds:.2f} s")
    report.update(stages=stages, seconds=seconds)
    return report


# ---------------------------------------------------------------------------
# phase 13: continuous serving with online fault detection
# ---------------------------------------------------------------------------

CONT_ENGINE = dict(num_slots=8, page_size=8, num_pages=1024, max_pages_per_seq=96,
                   prefill_buckets=(32, 64, 128, 256), chunk_size=256, max_pack=4)
CONT_PROBE_EVERY = 8
CONT_INJECT_AT = 24  # the dispatch at which set_silicon adds random_fault_map(42, 256, 256, 0.02)
CONT_LONG = (300, 513, 700)  # chunked prompts: 2, 3 and 3 chunks of 256, the 513's last of 1 token
CONT_TIE = 1e-3  # float32 tokens may part from the static engine's only at a near-tie this close


def continuous_traffic(np, vocab):
    """The phase's 24 requests, from ``np.random.default_rng(0)``: 16
    prompts of 8-120 tokens, 5 of 121-256 and the 3 long ones, greedy
    budgets of 4-48 (the 700-token prompt's 48, so its chain is the largest,
    94 pages), 12 arriving at 0 and the rest at dispatches 1-40 (the last at
    40). Returns ``(rid, prompt, budget, arrival)`` tuples."""
    rng = np.random.default_rng(0)
    lens = ([int(n) for n in rng.integers(8, 121, 16)] + [int(n) for n in rng.integers(121, 257, 5)]
            + list(CONT_LONG))
    budgets = [int(b) for b in rng.integers(4, 49, len(lens))]
    budgets[lens.index(max(CONT_LONG))] = 48
    arrivals = [0] * 12 + sorted(int(a) for a in rng.integers(1, 41, 11)) + [40]
    order = rng.permutation(len(lens))
    return [(i, rng.integers(0, vocab, lens[j]).astype(np.int32), budgets[j], arrivals[i])
            for i, j in enumerate(order)]


def weight_cast_watch(torch, shapes):
    """A dispatch mode that records every fp32 -> bf16 conversion of a
    tensor with a GEMM weight's shape (``.seen``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class WeightCasts(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (torch.ops.aten._to_copy.default, torch.ops.aten.copy_.default):
                src = args[1] if func is torch.ops.aten.copy_.default else args[0]
                dst = args[0] if func is torch.ops.aten.copy_.default else out
                if (isinstance(src, torch.Tensor) and src.dtype == torch.float32
                        and dst.dtype == torch.bfloat16 and tuple(src.shape) in shapes):
                    self.seen.append(tuple(src.shape))
            return out

    return WeightCasts()


_MISSING = object()


class labelled:
    """Within the block, each ``(owner, attr, label)`` call runs inside a
    ``torch.profiler.record_function`` range named ``label``; the attributes
    are put back on exit (an instance's own attribute is deleted again)."""

    def __init__(self, torch, targets):
        self.torch, self.targets, self.saved = torch, targets, []

    def __enter__(self):
        for owner, attr, label in self.targets:
            own = vars(owner).get(attr, _MISSING)
            fn = getattr(owner, attr)

            def wrapped(*a, _fn=fn, _label=label, **k):
                with self.torch.profiler.record_function(_label):
                    return _fn(*a, **k)

            self.saved.append((owner, attr, own))
            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, attr, own in reversed(self.saved):
            if own is _MISSING:
                delattr(owner, attr)
            else:
                setattr(owner, attr, own)
        self.saved.clear()


def host_costs(events, root, labels):
    """Host cost of each ``root`` range (one decode dispatch) by the
    ``labels`` ranges nested in it, from a profiler's CPU events
    (``prof.events()``). Returns ``(dispatches, groups)``: per label, per
    dispatch, its calls, its host microseconds less those of the labelled
    ranges inside it (``host_us``), of that the torch ops directly under it
    (``op_us``, ``ops``, the most frequent op names in ``top_ops``), the
    other traced calls directly under it (``runtime_calls``: the CUDA
    runtime's, such as a kernel launch made outside any torch op) and the
    runtime's kernel launch calls anywhere under it (``launch_calls``). The
    root's own row is what the dispatch runs outside every label."""
    from collections import Counter

    from torch.autograd import DeviceType

    names = set(labels) | {root}
    # a range traced with the card is mirrored on its stream: only the host's copy has children
    roots = [e for e in events if e.name == root and e.device_type == DeviceType.CPU]
    rows = {k: dict(calls=0, incl_us=0.0, inner_us=0.0, op_us=0.0, ops=0, runtime_calls=0, launch_calls=0,
                    names=Counter()) for k in [root, *labels]}

    def launches(e):
        return int("LaunchKernel" in e.name) + sum(launches(c) for c in e.cpu_children)

    def walk(e, label):
        row = rows[label]
        row["calls"] += 1
        row["incl_us"] += e.cpu_time_total
        for c in e.cpu_children:
            if c.name in names and c.name != root:
                rows[label]["inner_us"] += c.cpu_time_total
                walk(c, c.name)
            elif c.name.startswith("aten::"):
                row["ops"] += 1
                row["op_us"] += c.cpu_time_total
                row["names"][c.name] += 1
                row["launch_calls"] += launches(c)
            else:
                row["runtime_calls"] += 1
                row["launch_calls"] += launches(c)

    for e in roots:
        walk(e, root)
    n = max(len(roots), 1)
    groups = {
        k: dict(calls=r["calls"] / n, host_us=(r["incl_us"] - r["inner_us"]) / n, op_us=r["op_us"] / n,
                ops=r["ops"] / n, runtime_calls=r["runtime_calls"] / n, launch_calls=r["launch_calls"] / n,
                top_ops={name: c / n for name, c in r["names"].most_common(6)})
        for k, r in rows.items()
    }
    return len(roots), groups


def continuous_phase(torch, log, profile=False):
    """Continuous serving of SmolLM-135M at full width through
    ``ContinuousBatchingEngine`` in ``kernel`` mode on the chip
    ``random_fault_map(0, 256, 256, 0.1)``, with its gates; returns the
    phase's report and raises ``Failed`` on a missed gate.

    Every run warms the closed program set first (``warmup()``, after which
    no program may be first run during traffic) and then serves
    ``continuous_traffic``: (a) bf16 without probes, the served logprobs
    held to the plain path teacher-forced (``fap``, dense attention) by the
    anchored rule (RMS error against plain float32 at most ANCHOR_RATIO
    times plain bf16's own); (b) float32 without probes, the served
    logprobs elementwise at ``dtype_tol(float32, atol_scale=50)`` and every
    request's tokens equal to the static ``ServeEngine``'s (kernel mode, the
    same prompt and budget) but past a near-tie (the static sequence's top
    two logprobs, teacher-forced through the kernel path, within CONT_TIE);
    (c) bf16 with a probe every CONT_PROBE_EVERY dispatches and
    ``default_slo_rules()`` on unchanged silicon: (a)'s tokens and logprob
    bits, no detection, no alert; (d) bf16 with the chip's map joined by
    ``random_fault_map(42, 256, 256, 0.02)`` at dispatch CONT_INJECT_AT:
    detected by CONT_INJECT_AT + CONT_PROBE_EVERY x (suspect_after + 1), the
    reconstructed delta non-empty and within the true new faults,
    ``detect.new_faults`` fired. Each run's launches, per masked-GEMM
    variant, must be what its dispatches make: 211 ``decode`` a decode
    dispatch (M = 8), 210 ``mma`` and one ``decode`` (the unembed) a packed
    admission or chunk, one ``decode`` a canary probe (M = 5), one ``mma`` a
    structured probe (M = 257); float32 all ``v1``; no other kernel. A short
    bf16 serve under the weight-cast watch converts no GEMM weight. Before
    the serves, ``gemm_parity`` holds the masked GEMM to its plain version
    at every shape the path launches. ``profile`` adds run (a)'s busy share
    and the host's cost of a decode dispatch by op group."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core import from_fault_map, random_fault_map
    from repro_torch.kernels.common import dtype_tol
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.mamba_scan.ops import selective_scan
    from repro_torch.kernels.masked_matmul.ops import (
        masked_matmul, masked_matmul_checksummed, masked_matmul_ref, pick_variant,
    )
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.obs import HealthConfig, Recorder, default_slo_rules
    from repro_torch.obs.abft import select_probe_weight
    from repro_torch.serve import ContinuousBatchingEngine, Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    card = card_line()
    cfg = get_arch("smollm-135m")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    layer_gemms = sum(uses for _, _, uses in cfg.gemm_shapes()) - 1  # the tied unembed is the last
    params = M.init_params(cfg, 0, device=dev)
    fm = random_fault_map(0, cfg.array_rows, cfg.array_cols, 0.1)
    ctx_k = from_fault_map(fm, "kernel", device=dev)
    ctx_f = from_fault_map(fm, "fap", device=dev)
    new_map = fm.merge(random_fault_map(42, cfg.array_rows, cfg.array_cols, 0.02))
    true_new = new_map.faulty & ~fm.faulty
    traffic = continuous_traffic(np, cfg.vocab_size)
    others = (flash_attention, selective_scan, da.decode_attention, da.paged_decode_attention)
    report, stages = {}, {}
    totals = dict.fromkeys(masked_matmul.launches_by_variant, 0)

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
        return out

    def reset():
        masked_matmul.launches = 0
        masked_matmul.launches_by_variant = dict.fromkeys(masked_matmul.launches_by_variant, 0)
        for fn in others:
            fn.launches = 0

    def run(c, label, probe=False, inject=False):
        """Build, warm and serve once; gate the launch counts. Returns the
        engine, the outputs, the stats and the run's numbers."""
        ctx_live = dict(ctx=ctx_k)
        eng = ContinuousBatchingEngine(
            c, params, ctx_k, recorder=Recorder(), **CONT_ENGINE,
            probe_every=CONT_PROBE_EVERY if probe else None,
            alert_rules=default_slo_rules() if probe else None,
        )
        t0 = time.perf_counter()
        warmed = eng.warmup()
        warm_s = time.perf_counter() - t0
        counts_warm = eng.compile_counts()

        def on_step(clock):
            if inject and clock >= CONT_INJECT_AT and ctx_live["ctx"] is ctx_k:
                ctx_live["ctx"] = from_fault_map(new_map, "kernel", device=dev)
                eng.set_silicon(ctx_live["ctx"])

        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        outs, stats = eng.serve([Request(*r) for r in traffic], on_step=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(masked_matmul.launches_by_variant)
        cc = eng.compile_counts()
        if cc["jit_fallback"] or warmed != len(CONT_ENGINE["prefill_buckets"]) + 2:
            raise Failed(f"continuous {label}: warmup() ran {warmed} programs; after traffic {cc}")
        prefills = stats.prefill_dispatches
        probes = eng.health.chips[0].probes if probe else 0
        structured = stats.probe_dispatches - probes
        per_decode = layer_gemms + 1
        if c.dtype == "bfloat16":
            want = dict(v1=0, decode=per_decode * stats.decode_dispatches + prefills + probes,
                        mma=layer_gemms * prefills + structured)
        else:
            want = dict(v1=per_decode * (stats.decode_dispatches + prefills) + stats.probe_dispatches,
                        decode=0, mma=0)
        stray = {fn.__name__: fn.launches for fn in others if fn.launches}
        if got != want or stray:
            raise Failed(f"continuous {label}: launches {got} (and {stray}), expected {want} from "
                         f"{stats.as_dict()} and {probes} probes")
        for k in totals:
            totals[k] += got[k]
        hist = eng.obs.metrics.histogram("serve.decode_step_s")
        ttft = np.array([o.ttft_wall_s for o in outs.values()])
        numbers = dict(
            stats=stats.as_dict(), wall_s=wall, warmup_s=warm_s, warmed=warmed,
            compile_counts_after_warmup=counts_warm, compile_counts=cc,
            tokens_per_s=stats.emitted_tokens / wall, decode_dispatch_ms=hist.mean * 1e3,
            ttft_p50_s=float(np.percentile(ttft, 50)), ttft_p99_s=float(np.percentile(ttft, 99)),
            launches=got, probes=probes, structured_probes=structured,
        )
        log(f"continuous {label} ({card}): {stats.emitted_tokens} tokens of {len(traffic)} requests in "
            f"{wall:.3f} s ({numbers['tokens_per_s']:.1f} tokens/s); {numbers['decode_dispatch_ms']:.3f} ms a "
            f"decode dispatch (mean of {hist.count}); TTFT p50 {numbers['ttft_p50_s'] * 1e3:.1f} ms, p99 "
            f"{numbers['ttft_p99_s'] * 1e3:.1f} ms (wall, queue wait included); warmup {warmed} programs in "
            f"{warm_s:.2f} s, compile_counts after warmup {counts_warm}, after traffic {cc}; stats "
            f"{stats.as_dict()}; launches {got} ({probes} probes, {structured} structured)")
        return eng, outs, stats, numbers

    def teacher_forced(c, ctx, emitted):
        """Each request's prompt and emitted tokens (``emitted[rid]``) through
        ``forward``: the logprobs of the emitted tokens and, per request, the
        log-softmax rows that chose them."""
        lps, rows = {}, {}
        with torch.no_grad():
            for rid, prompt, _, _ in traffic:
                if rid not in emitted:
                    continue
                toks = np.concatenate([prompt, emitted[rid]]).astype(np.int64)
                seq = torch.as_tensor(toks, device=dev)[None]
                logits = M.forward(params, {"tokens": seq[:, :-1]}, c, ctx, attn_impl="dense")[0][0]
                lp = torch.log_softmax(logits[len(prompt) - 1 :].float(), -1)
                rows[rid] = lp
                lps[rid] = lp.gather(-1, seq[0, len(prompt):, None])[:, 0]
        return lps, rows

    def flat(d):
        """One request-ordered vector of per-token values (numpy or tensors)."""
        return torch.cat([torch.as_tensor(d[rid]).to(dev).float().reshape(-1) for rid, *_ in traffic])

    def gemm_parity():
        """The masked GEMM's wrapper against ``masked_matmul_ref`` on the
        same x, w and ok at ``dtype_tol``, at every M this path launches, on
        the model's own weights: layer 0's seven GEMMs at M = num_slots (a
        decode dispatch) and at each bucket (a packed admission; a chunk is
        the top bucket), the tied unembed at M = num_slots, max_pack (an
        admission's) and 1 (a chunk's), and ``masked_matmul_checksummed`` on
        the probe weight at M = 4 + 1 (the canary) and 256 + 1 (the
        structured probe), under the chip's map and the injected one. bf16 x
        meets the fp32 master, as kernel mode hands it over; float32 x its
        own dtype. Returns one row per case; raises ``Failed`` on a miss."""
        attn, mlp = params.layers[0].attn, params.layers[0].mlp
        ws = dict(wq=attn.wq, wk=attn.wk, wv=attn.wv, wo=attn.wo, wg=mlp.wg, wu=mlp.wu, wd=mlp.wd)
        unembed_w = params.embed.T  # tied: the strided view the path reads
        shapes = {tuple(w.shape) for w in ws.values()} | {tuple(unembed_w.shape)}
        if shapes != {(k_, n_) for k_, n_, _ in cfg.gemm_shapes()}:
            raise Failed(f"continuous parity: weights {sorted(shapes)} are not the config's GEMMs")
        probe_name, probe_w = select_probe_weight(params)
        slots, buckets = CONT_ENGINE["num_slots"], CONT_ENGINE["prefill_buckets"]
        cases = [(name, w, m, False, ctx_k.ok) for name, w in ws.items() for m in (slots, *buckets)]
        cases += [("unembed", unembed_w, m, False, ctx_k.ok) for m in (slots, CONT_ENGINE["max_pack"], 1)]
        injected_ok = from_fault_map(new_map, "kernel", device=dev).ok
        cases += [(probe_name, probe_w, m, True, ok) for m in (4, 256) for ok in (ctx_k.ok, injected_ok)]
        g = torch.Generator(device=dev).manual_seed(1)
        rows = []
        with torch.no_grad():
            for dtype in (torch.bfloat16, torch.float32):
                rtol, atol = dtype_tol(dtype)
                for name, w, m, checked, ok in cases:
                    x = torch.randn(m, w.shape[0], generator=g, device=dev).to(dtype)
                    if checked:  # the probe: 1^T x appended, one launch of the same GEMM
                        y, chk = masked_matmul_checksummed(x, w, ok)
                        got = torch.cat([y, chk[None]])
                        ref = masked_matmul_ref(torch.cat([x, x.sum(0, keepdim=True).to(dtype)]), w, ok)
                    else:
                        got, ref = masked_matmul(x, w, ok), masked_matmul_ref(x, w, ok)
                    diff = (got.float() - ref.float()).abs()
                    good = bool((diff <= atol + rtol * ref.float().abs()).all())
                    row = dict(dtype=str(dtype)[6:], weight=name, m=int(got.shape[0]), k=int(w.shape[0]),
                               n=int(w.shape[1]), variant=pick_variant(dtype, int(got.shape[0])),
                               checksummed=checked, max_abs_err=float(diff.max()), ok=good)
                    rows.append(row)
                    if not good:
                        raise Failed(f"continuous parity: masked GEMM misses masked_matmul_ref at "
                                     f"dtype_tol {(rtol, atol)}: {row}")
        by = {}
        for r in rows:
            key = (r["dtype"], r["variant"])
            ms, err = by.get(key, (set(), 0.0))
            by[key] = (ms | {r["m"]}, max(err, r["max_abs_err"]))
        log(f"continuous parity: the masked GEMM against masked_matmul_ref at the path's shapes, {len(rows)} cases "
            f"(probe weight {probe_name}): " + "; ".join(
                f"{dt} {v} at M {sorted(ms)} max err {err:.3g} (rtol, atol {dtype_tol(getattr(torch, dt))})"
                for (dt, v), (ms, err) in by.items()))
        return rows

    report["parity"] = timed("masked GEMM parity", gemm_parity)

    # -- (a) bf16, probes off: the anchored rule -------------------------------------
    eng_a, outs_a, stats_a, report["a"] = timed("serve (a)", run, cfg, "(a) bf16")
    served = flat({rid: o.logprobs for rid, o in outs_a.items()})
    emitted_a = {rid: o.tokens for rid, o in outs_a.items()}
    ref_lp, _ = timed("teacher-forced", teacher_forced, cfg, ctx_f, emitted_a)
    ref32_lp, _ = timed("teacher-forced", teacher_forced, cfg32, ctx_f, emitted_a)
    plain_rms = float((flat(ref_lp) - flat(ref32_lp)).pow(2).mean().sqrt())
    served_rms = float((served - flat(ref32_lp)).pow(2).mean().sqrt())
    report["a"].update(plain_lp_rms=plain_rms, served_lp_rms=served_rms,
                       max_err_vs_plain=float((served - flat(ref_lp)).abs().max()))
    log(f"continuous (a) bf16 against the plain path in float32: logprob RMS err plain bf16 teacher-forced "
        f"{plain_rms:.4g}, served {served_rms:.4g} (ratio {served_rms / plain_rms:.3f} <= {ANCHOR_RATIO}); "
        f"max err against plain bf16 {report['a']['max_err_vs_plain']:.3g}")
    if not torch.isfinite(served).all() or served_rms > ANCHOR_RATIO * plain_rms:
        raise Failed(f"continuous (a): served logprobs farther from plain float32 than plain bf16: {report['a']}")
    shapes = {sh for k_, n_, _ in cfg.gemm_shapes() for sh in ((k_, n_), (n_, k_))}
    watch = weight_cast_watch(torch, shapes)
    t0 = time.perf_counter()
    with watch:
        eng_a.serve([Request(0, traffic[0][1][:40], 2), Request(1, traffic[1][1][:300], 2)])
        torch.cuda.synchronize()
    stages["weight-cast watch"] = time.perf_counter() - t0
    report["weight_casts"] = len(watch.seen)
    if watch.seen:
        raise Failed(f"continuous: kernel mode cast GEMM weights to bf16: {watch.seen[:8]}")
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        t_prof = time.perf_counter()
        reqs = [Request(*r) for r in traffic]
        t0 = time.perf_counter()
        eng_a.serve(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng_a.serve(reqs)
            torch.cuda.synchronize()
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
        report["a"]["profile"] = dict(wall_ms=wall_ms, busy_ms=busy_ms, busy_share=busy_ms / wall_ms)
        log(f"continuous (a) profile ({card}): untraced wall {wall_ms:.2f} ms, traced device time "
            f"{busy_ms:.2f} ms, busy {busy_ms / wall_ms:.1%}")
        # the host's side: the same traffic traced on the CPU too, each decode dispatch's
        # enqueue (the sampling and decode_step, not the wait for its tokens) and the
        # model's op groups in labelled ranges
        root = "decode dispatch"
        targets = [
            (eng_a, "_decode", root),
            (M, "decode_step", "decode_step (embed, positions, lengths)"),
            (M, "apply_norm", "RMSNorm"),
            (M, "_rope", "RoPE tables"),
            (M, "attention_block", "attention block (page scatter, chain gather, masks)"),
            (L, "apply_rope", "RoPE"),
            (L, "dense_attention", "dense attention"),
            (M, "mlp_block", "MLP (SiLU, product)"),
            (M, "unembed", "unembed"),
            (L, "fault_linear", "masked GEMM (fault_linear)"),
            (M, "fault_linear", "masked GEMM (fault_linear)"),
        ]
        with labelled(torch, targets), torch_profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_cpu:
            eng_a.serve(reqs)
            torch.cuda.synchronize()
        n_disp, groups = host_costs(prof_cpu.events(), root, sorted({t[2] for t in targets[1:]}))
        report["a"]["profile"]["host"] = dict(dispatches=n_disp, groups=groups)
        total_us = sum(g["host_us"] for g in groups.values())
        log(f"continuous (a) host per decode dispatch ({card}; traced, CPU and CUDA; {n_disp} dispatches): "
            f"{total_us / 1e3:.3f} ms to enqueue, {sum(g['ops'] for g in groups.values()):.0f} torch ops, "
            f"{sum(g['launch_calls'] for g in groups.values()):.0f} kernel launch calls seen by the runtime trace")
        for label, g in sorted(groups.items(), key=lambda kv: -kv[1]["host_us"]):
            log(f"  {label}: {g['calls']:.0f} calls, {g['host_us']:.1f} us host ({g['op_us']:.1f} in "
                f"{g['ops']:.0f} torch ops; {g['runtime_calls']:.0f} other runtime calls, {g['launch_calls']:.0f} "
                f"launch calls); ops {g['top_ops']}")
        stages["profile"] = time.perf_counter() - t_prof
    del eng_a

    # -- (b) float32, probes off: elementwise, and pinned to the static engine --------
    eng_b, outs_b, _, report["b"] = timed("serve (b)", run, cfg32, "(b) float32")
    del eng_b
    rtol, atol = dtype_tol(torch.float32, atol_scale=50.0)
    ref_lp32, _ = timed("teacher-forced", teacher_forced, cfg32, ctx_f, {rid: o.tokens for rid, o in outs_b.items()})
    got_b, want_b = flat({rid: o.logprobs for rid, o in outs_b.items()}), flat(ref_lp32)
    err_b = float((got_b - want_b).abs().max())
    static = ServeEngine(cfg32, params, ctx_k, max_len=None)
    parted, static_outs = [], {}
    t0 = time.perf_counter()
    for rid, prompt, budget, _ in traffic:
        res = static.generate(torch.as_tensor(prompt.astype(np.int64), device=dev)[None], max_new_tokens=budget)
        static_outs[rid] = res.tokens[0, len(prompt):].cpu().numpy()
    stages["static engine (b)"] = time.perf_counter() - t0
    differ = {rid: t for rid, t in static_outs.items() if not np.array_equal(t, outs_b[rid].tokens)}
    _, static_rows = timed("teacher-forced", teacher_forced, cfg32, ctx_k, differ) if differ else (None, {})
    for rid, *_ in traffic:
        a, b = outs_b[rid].tokens, static_outs[rid]
        if rid in differ:
            i = int(np.flatnonzero(a != b)[0])
            top2 = static_rows[rid][i].topk(2).values
            gap = float(top2[0] - top2[1])
            parted.append(dict(rid=rid, at=i, gap=gap))
            if gap > CONT_TIE:
                raise Failed(f"continuous (b): request {rid} parts from the static engine at token {i}, "
                             f"where its top two logprobs are {gap:.3g} apart (> {CONT_TIE})")
    report["b"].update(logprob_err=err_b, parted_from_static=parted)
    log(f"continuous (b) float32: served logprobs against plain float32 teacher-forced max err {err_b:.3g} "
        f"(rtol {rtol}, atol {atol}); tokens against the static engine: "
        f"{len(traffic) - len(parted)} of {len(traffic)} equal, near-ties {parted}")
    if not bool(((got_b - want_b).abs() <= atol + rtol * want_b.abs()).all()):
        raise Failed(f"continuous (b): served logprobs disagree with the plain path: max err {err_b:.3g}")

    # -- (c) bf16 with probes on unchanged silicon ----------------------------------
    eng_c, outs_c, stats_c, report["c"] = timed("serve (c)", run, cfg, "(c) bf16 probes", probe=True)
    same = all(np.array_equal(outs_c[r].tokens, outs_a[r].tokens)
               and np.array_equal(outs_c[r].logprobs, outs_a[r].logprobs) for r in outs_a)
    health, alerts = eng_c.health.summary(), eng_c.alerts.summary()
    report["c"].update(same_bits_as_a=same, health=health, alerts=alerts)
    log(f"continuous (c) bf16 with probes: tokens and logprob bits as (a): {same}; health "
        f"{eng_c.health.state(0)}, detections {eng_c.health.detections}, alerts fired {alerts['fired']}, "
        f"probe dispatches {stats_c.probe_dispatches} (weight {eng_c._probe_weight})")
    if (not same or eng_c.health.detections or eng_c.health.state(0) != "healthy" or alerts["fired"]
            or not stats_c.probe_dispatches):
        raise Failed(f"continuous (c): probes on unchanged silicon: same bits {same}, {health}, {alerts}")
    del eng_c

    # -- (d) bf16 with a silicon change injected at dispatch 24 ---------------------
    eng_d, outs_d, stats_d, report["d"] = timed("serve (d)", run, cfg, "(d) bf16 injected", probe=True, inject=True)
    hc = HealthConfig()
    bound = CONT_INJECT_AT + CONT_PROBE_EVERY * (hc.suspect_after + 1)
    at, delta = eng_d.health.detected_at(0), eng_d.health.last_delta(0)
    fired = eng_d.alerts.summary()["fired"]
    report["d"].update(
        detected_at=at, bound=bound, delta_faults=int(delta.sum()) if delta is not None else 0,
        true_new_faults=int(true_new.sum()), fired=fired, health=eng_d.health.summary(),
    )
    log(f"continuous (d) bf16 injected at dispatch {CONT_INJECT_AT}: detected at {at} (bound {bound}), "
        f"delta {report['d']['delta_faults']} PEs of {report['d']['true_new_faults']} new faults, "
        f"state {eng_d.health.state(0)}, alerts fired {fired}")
    if (at is None or at > bound or delta is None or not delta.any() or (delta & ~true_new).any()
            or "detect.new_faults" not in fired):
        raise Failed(f"continuous (d): injection not detected as required: {report['d']}")
    # the donation pass over the engine's three programs, kernel mode, bf16: one dispatch each
    from repro_torch.analysis.programs import continuous_specs

    per_step = layer_gemms + 1
    report["donation"] = timed("donation", donation_gate, torch, log, "phase 13", continuous_specs(eng_d), {
        "continuous.sample_decode": per_step, "continuous.prefill_admit": per_step,
        "continuous.prefill_chunk": per_step})
    del eng_d, params
    gc.collect()
    torch.cuda.empty_cache()
    report.update(launches=totals, stages=stages, seconds=time.perf_counter() - t_phase)
    log(f"continuous phase ({card}): {report['seconds']:.2f} s; stages (s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()) + f"; masked-GEMM launches {totals}")
    return report


# ---------------------------------------------------------------------------
# phase 14: fleet serving
# ---------------------------------------------------------------------------

FLEET_CHIPS = 8  # (a): FleetServeEngine, random_fault_map(c, 256, 256, 0.05 * c), chip 0 healthy
FLEET_STREAM_CHIPS = 4  # (b): ShardedFleetServeEngine, one request stream each
FLEET_REQUESTS = 12  # per chip: 11 prompts of 8-256 tokens and one of 300 (two chunks)
FLEET_ENGINE = dict(num_slots=8, page_size=8, num_pages=512, max_pages_per_seq=64,
                    prefill_buckets=(32, 64, 128, 256), chunk_size=256, max_pack=4)
FLEET_PROBE_EVERY = 8
FLEET_INJECT_AT = 24  # the dispatch at which set_silicon joins random_fault_map(42, 256, 256, 0.02)
FLEET_VICTIM = 2  # ... to this chip's map


def fleet_traffic(np, vocab, chip):
    """Chip ``chip``'s request stream, from ``np.random.default_rng(chip)``:
    FLEET_REQUESTS - 1 prompts of 8-256 tokens and one of 300 (two chunks of
    256) in a random place, greedy budgets of 4-48, arrivals at dispatches
    0-20 with the first three at 0. Tuples (rid, prompt, budget, arrival)."""
    rng = np.random.default_rng(chip)
    lens = [*rng.integers(8, 257, FLEET_REQUESTS - 1), 300]
    order = rng.permutation(FLEET_REQUESTS)
    budgets = rng.integers(4, 49, FLEET_REQUESTS)
    arrivals = np.sort(rng.integers(0, 21, FLEET_REQUESTS))
    arrivals[:3] = 0
    return [(rid, rng.integers(0, vocab, int(lens[order[rid]])), int(budgets[rid]), int(arrivals[rid]))
            for rid in range(FLEET_REQUESTS)]


def event_ms(torch, fn, flush, reps=10):
    """Median of single calls timed by CUDA events, each with the L2 cache
    overwritten first, as a serving step finds it."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def fleet_phase(torch, log, profile=False):
    """Fleet serving of SmolLM-135M at full width in ``kernel`` mode, chips
    ``random_fault_map(c, 256, 256, 0.05 * c)``; returns the phase's report
    and raises ``Failed`` on a missed gate.

    (a) ``FleetServeEngine``, FLEET_CHIPS chips (params from seed c // 4,
    chip 0 healthy), the four 128-token prompts of ``default_rng(0)`` shared,
    32 greedy new tokens, in bf16 and float32. Each chip is held to its own
    ``ServeEngine`` (exact-length prefill, the same cache): float32 tokens
    equal but past a near-tie of CONT_TIE and logprobs within
    ``dtype_tol(float32, atol_scale=50)``; bf16 logprobs anchored (RMS
    error against plain float32 teacher-forced at most ANCHOR_RATIO times
    plain bf16's own). The faulty chips' tokens must differ from chip 0's.
    Every masked GEMM of the run is one chip-batched launch: 211 per fused
    decode dispatch and 211 for the prefill, whatever the chip count.
    (b) ``ShardedFleetServeEngine``, FLEET_STREAM_CHIPS chips (chip 0 a
    zero-fault map, so every mask is live), each with its own stream
    (``fleet_traffic``), FLEET_ENGINE: bf16 anchored, float32 tokens equal to
    each chip's own ``ContinuousBatchingEngine`` on its stream (the near-tie
    rule); a control run with a probe every FLEET_PROBE_EVERY dispatches
    detects nothing and gives the no-probe run's bits; then chip
    FLEET_VICTIM's map is joined by ``random_fault_map(42, 256, 256, 0.02)``
    at dispatch FLEET_INJECT_AT (``set_silicon``): that chip must reach
    SUSPECT or worse within the debounce bound, its delta non-empty and
    within the true new faults; the other chips detect nothing and their
    tokens are bit-equal to the control run's; ``detect.new_faults`` fires.
    Each decode dispatch is 211 chip-batched launches; each admission and
    probe a single-chip launch.
    (c) Report: fleet tokens/s, ms a fused dispatch, TTFT p50/p99 per chip,
    the per-chip engines on the same traffic in turn and the dispatch
    amortization. The chip-batched masked GEMM at FLEET_CHIPS chips is held
    to its plain version at ``dtype_tol`` of x's dtype at every shape (a)
    and (b) launch it with: M = 4, the slot count and 512, bf16 x (decode,
    mma) and float32 x (v1), one counted launch each; and timed at
    one decode step's shapes (M = 4) and (a)'s prefill (M = 512) against
    its bound (the chips' bytes, the fp32 master read in place), the same
    launches one chip at a time, ``torch.bmm`` on pre-masked bf16 weights
    (the library time) and the plain version. ``profile`` adds the busy
    share of (b)'s bf16 run.
    (d) ``fleet_families``: hymba-1.5b (4 chips) and mixtral-8x22b (depth
    1, 2 chips) at full width through ``FleetServeEngine``, the scan and the
    expert GEMMs one launch over the chips, each held to its plain
    version."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core import from_fault_map, healthy, random_fault_map
    from repro_torch.core.mapping import periodic_mask
    from repro_torch.fleet import FleetServeEngine, ShardedFleetServeEngine
    from repro_torch.kernels.common import dtype_tol
    from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_ref, pick_variant
    from repro_torch.models import model as M
    from repro_torch.obs import HEALTHY, HealthConfig, Recorder, default_slo_rules
    from repro_torch.serve import ContinuousBatchingEngine, Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    card = card_line()
    cfg = get_arch("smollm-135m")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    per_step = sum(u for _, _, u in cfg.gemm_shapes())  # 211: 30 layers x 7 and the tied unembed
    rows_, cols_ = cfg.array_rows, cfg.array_cols
    maps = [random_fault_map(c, rows_, cols_, 0.05 * c) for c in range(FLEET_CHIPS)]
    models = [M.init_params(cfg, s, device=dev) for s in range(2)]
    params = [models[c // 4] for c in range(FLEET_CHIPS)]
    report, stages = {}, {}
    fleet_totals = dict.fromkeys(masked_matmul.launches_by_variant, 0)
    rtol32, atol32 = dtype_tol(torch.float32, atol_scale=50.0)

    def reset():
        masked_matmul.launches = 0
        masked_matmul.launches_by_variant = dict.fromkeys(masked_matmul.launches_by_variant, 0)
        masked_matmul.fleet_launches_by_variant = dict.fromkeys(masked_matmul.launches_by_variant, 0)

    def counts():
        return dict(masked_matmul.launches_by_variant), dict(masked_matmul.fleet_launches_by_variant)

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
        return out

    def forced(c_cfg, p, ctx, seq, start):
        """log-softmax rows of ``seq`` (B, S) teacher-forced through
        ``forward`` from position ``start - 1`` on: the rows that chose
        ``seq[:, start:]``."""
        with torch.no_grad():
            logits = M.forward(p, {"tokens": seq[:, :-1]}, c_cfg, ctx, attn_impl="dense")[0]
        return torch.log_softmax(logits[:, start - 1:].float(), -1)

    def chosen(rows, seq, start):
        return rows.gather(-1, seq[:, start:, None])[..., 0]

    def anchored(label, c, served_lp, seq, start):
        """The bf16 served logprobs against plain float32 teacher-forced on
        the served sequence, beside plain bf16's own error: (plain, served)."""
        ctx_f = from_fault_map(maps[c], "fap", device=dev)
        lp16 = chosen(forced(cfg, params[c], ctx_f, seq, start), seq, start)
        lp32 = chosen(forced(cfg32, params[c], ctx_f, seq, start), seq, start)
        plain = float((lp16 - lp32).pow(2).mean().sqrt())
        served = float((served_lp.float() - lp32).pow(2).mean().sqrt())
        if not bool(torch.isfinite(served_lp).all()) or served > ANCHOR_RATIO * plain:
            raise Failed(f"fleet {label} chip {c}: served logprobs RMS err {served:.4g} against plain float32, "
                         f"more than {ANCHOR_RATIO} x plain bf16's {plain:.4g}")
        return plain, served

    def near_tie(label, c_cfg, c, ctx, seq, other, start):
        """Where ``other``'s tokens part from ``seq``'s (both (S,), prompt
        first), the gap of ``seq``'s top two logprobs there, teacher-forced
        through the kernel path; raises past CONT_TIE. Returns the index of
        the first parting token (in the generated part) or None."""
        diff = np.flatnonzero(seq[start:] != other[start:])
        if not diff.size:
            return None
        i = int(diff[0])
        t = torch.as_tensor(seq[None].astype(np.int64), device=dev)
        top2 = forced(c_cfg, params[c], ctx, t, start)[0, i].topk(2).values
        gap = float(top2[0] - top2[1])
        if gap > CONT_TIE:
            raise Failed(f"fleet {label} chip {c}: tokens part from its own engine at token {i}, where the top "
                         f"two logprobs are {gap:.3g} apart (> {CONT_TIE})")
        return dict(chip=c, at=i, gap=gap)

    # -- (a) FleetServeEngine: 8 chips, one shared prompt batch --------------------
    prompts = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (BATCH, PROMPT)), device=dev)
    ctxs_a = [healthy() if c == 0 else from_fault_map(maps[c], "kernel", device=dev) for c in range(FLEET_CHIPS)]
    max_len = PROMPT + NEW
    report["a"] = {}
    for c_cfg in (cfg, cfg32):
        dt = c_cfg.dtype
        eng = FleetServeEngine(c_cfg, params, ctxs_a, max_len=max_len)
        timed(f"(a) {dt} warm", eng.generate, prompts[:, :16], max_new_tokens=2)
        reset()
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new_tokens=NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stages[f"(a) {dt} fleet"] = wall
        got, fleet = counts()
        want = (dict(v1=per_step * (1 + NEW), decode=0, mma=0) if dt == "float32"
                else dict(v1=0, decode=1 + per_step * NEW, mma=per_step - 1))
        if got != want or fleet != got:
            raise Failed(f"fleet (a) {dt}: launches {got}, chip-batched {fleet}, expected {want} (all "
                         f"chip-batched: {per_step} a fused decode dispatch and {per_step} for the prefill)")
        for k in fleet_totals:
            fleet_totals[k] += fleet[k]
        t0 = time.perf_counter()
        refs = [ServeEngine(c_cfg, params[c], ctxs_a[c], max_len=max_len, prefill_buckets=None)
                .generate(prompts, max_new_tokens=NEW) for c in range(FLEET_CHIPS)]
        torch.cuda.synchronize()
        serial = time.perf_counter() - t0
        stages[f"(a) {dt} per-chip engines"] = serial
        toks = out.tokens.cpu().numpy()
        rec = dict(wall_s=wall, per_chip_engines_s=serial, tokens_per_s=FLEET_CHIPS * BATCH * NEW / wall,
                   ms_per_dispatch=wall / (NEW + 1) * 1e3, launches=got, chip_batched=fleet,
                   launches_per_decode_dispatch=(sum(got.values()) - per_step) / NEW)
        for c in range(1, FLEET_CHIPS):
            if np.array_equal(toks[c, :, PROMPT:], toks[0, :, PROMPT:]):
                raise Failed(f"fleet (a) {dt}: chip {c} (rate {0.05 * c:.2f}) gives chip 0's tokens")
        if dt == "float32":
            parted, err = [], 0.0
            for c in range(FLEET_CHIPS):
                ref_t = refs[c].tokens.cpu().numpy()
                for b in range(BATCH):
                    p = near_tie("(a) float32", c_cfg, c, ctxs_a[c], ref_t[b], toks[c, b], PROMPT)
                    upto = NEW if p is None else p["at"] + 1
                    if p is not None:
                        parted.append(dict(p, row=b))
                    d = (out.logprobs[c, b, :upto] - refs[c].logprobs[b, :upto]).abs()
                    err = max(err, float(d.max()))
                    if not bool((d <= atol32 + rtol32 * refs[c].logprobs[b, :upto].abs()).all()):
                        raise Failed(f"fleet (a) float32 chip {c} row {b}: logprobs differ from its ServeEngine "
                                     f"by {float(d.max()):.3g} (rtol {rtol32}, atol {atol32})")
            rec.update(logprob_err=err, parted=parted)
            log(f"fleet (a) float32: every chip against its own ServeEngine: logprob max err {err:.3g} "
                f"(rtol {rtol32}, atol {atol32}); tokens equal but {len(parted)} near-ties {parted}")
        else:
            anchors = [anchored("(a) bf16", c, out.logprobs[c], out.tokens[c], PROMPT) for c in range(FLEET_CHIPS)]
            rec.update(anchors=anchors)
            log(f"fleet (a) bf16: logprob RMS err against plain float32, (plain bf16, served) per chip: "
                + ", ".join(f"{a[0]:.4g}/{a[1]:.4g}" for a in anchors) + f" (served <= {ANCHOR_RATIO} x plain)")
        log(f"fleet (a) {dt} ({card}): {FLEET_CHIPS} chips x {BATCH} prompts x {NEW} tokens in {wall:.3f} s "
            f"({rec['tokens_per_s']:.1f} tokens/s, {rec['ms_per_dispatch']:.2f} ms a fused dispatch, prefill "
            f"included); the per-chip ServeEngines in turn {serial:.3f} s ({serial / wall:.2f}x); launches {got}, "
            f"all chip-batched, {rec['launches_per_decode_dispatch']:.0f} a fused decode dispatch")
        report["a"][dt] = rec
        del eng, out, refs

    # -- (b) ShardedFleetServeEngine: one ragged stream per chip -------------------
    n_b = FLEET_STREAM_CHIPS
    traffic = [fleet_traffic(np, cfg.vocab_size, c) for c in range(n_b)]
    streams = [[Request(*r) for r in t] for t in traffic]
    ctxs_b = [from_fault_map(maps[c], "kernel", device=dev) for c in range(n_b)]
    new_map = maps[FLEET_VICTIM].merge(random_fault_map(42, rows_, cols_, 0.02))
    true_new = new_map.faulty & ~maps[FLEET_VICTIM].faulty
    hc = HealthConfig()

    def run_b(c_cfg, label, probe=False, inject=False):
        eng = ShardedFleetServeEngine(
            c_cfg, params[:n_b], ctxs_b, devices=[dev], recorder=Recorder(), **FLEET_ENGINE,
            probe_every=FLEET_PROBE_EVERY if probe else None,
            alert_rules=default_slo_rules() if probe else None,
        )
        live = dict(done=False)

        def on_step(clock):
            if inject and clock >= FLEET_INJECT_AT and not live["done"]:
                live["done"] = True
                eng.set_silicon(FLEET_VICTIM, from_fault_map(new_map, "kernel", device=dev))

        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        outs, stats = eng.serve(streams, on_step=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, fleet = counts()
        probes = sum(eng.health.chips[c].probes for c in range(n_b)) if probe else 0
        structured = stats.probe_dispatches - probes
        pre = stats.prefill_dispatches
        if c_cfg.dtype == "bfloat16":
            want = dict(v1=0, decode=per_step * stats.decode_dispatches + pre + probes,
                        mma=(per_step - 1) * pre + structured)
            want_fleet = dict(v1=0, decode=per_step * stats.decode_dispatches, mma=0)
        else:
            want = dict(v1=per_step * (stats.decode_dispatches + pre) + stats.probe_dispatches, decode=0, mma=0)
            want_fleet = dict(v1=per_step * stats.decode_dispatches, decode=0, mma=0)
        if got != want or fleet != want_fleet:
            raise Failed(f"fleet {label}: launches {got}, chip-batched {fleet}; expected {want} and {want_fleet} "
                         f"from {stats.as_dict()} and {probes} probes")
        for k in fleet_totals:
            fleet_totals[k] += fleet[k]
        hist = eng.obs.metrics.histogram("serve.decode_step_s")
        ttft = [np.array([o.ttft_wall_s for o in outs[c].values()]) for c in range(n_b)]
        numbers = dict(
            stats=stats.as_dict(), wall_s=wall, tokens_per_s=stats.emitted_tokens / wall,
            ms_per_dispatch=hist.mean * 1e3, launches=got, chip_batched=fleet, probes=probes,
            ttft_p50_s=[float(np.percentile(t, 50)) for t in ttft],
            ttft_p99_s=[float(np.percentile(t, 99)) for t in ttft],
        )
        log(f"fleet {label} ({card}): {n_b} chips, {stats.emitted_tokens} tokens of {n_b * FLEET_REQUESTS} "
            f"requests in {wall:.3f} s ({numbers['tokens_per_s']:.1f} tokens/s); {stats.decode_dispatches} fused "
            f"dispatches, {numbers['ms_per_dispatch']:.2f} ms each (mean of {hist.count}); {pre} admissions "
            f"({stats.chunk_dispatches} chunks); TTFT p50 / p99 per chip (ms): "
            + ", ".join(f"{a * 1e3:.0f}/{b * 1e3:.0f}" for a, b in zip(numbers["ttft_p50_s"], numbers["ttft_p99_s"]))
            + f"; launches {got}, chip-batched {fleet}")
        return eng, outs, stats, numbers

    def per_chip(c_cfg):
        outs, disp = [], 0
        t0 = time.perf_counter()
        for c in range(n_b):
            o, st = ContinuousBatchingEngine(c_cfg, params[c], ctxs_b[c], **FLEET_ENGINE).serve(streams[c])
            outs.append(o)
            disp += st.decode_dispatches
        torch.cuda.synchronize()
        return outs, disp, time.perf_counter() - t0

    def seq_of(c, rid, o):
        return np.concatenate([traffic[c][rid][1], o.tokens]).astype(np.int64)

    timed("(b) warm", ShardedFleetServeEngine(cfg, params[:n_b], ctxs_b, devices=[dev], **FLEET_ENGINE).serve,
          [[Request(0, traffic[c][0][1][:40], 2), Request(1, np.resize(traffic[c][0][1], 300), 2)]
           for c in range(n_b)])
    report["b"] = {}
    for c_cfg in (cfg, cfg32):
        dt = c_cfg.dtype
        eng, outs, stats, rec = timed(f"(b) {dt} fleet", run_b, c_cfg, f"(b) {dt}")
        ref_outs, ref_disp, ref_wall = timed(f"(b) {dt} per-chip engines", per_chip, c_cfg)
        rec.update(per_chip_engines_s=ref_wall, per_chip_dispatches=ref_disp,
                   dispatch_amortization=ref_disp / stats.decode_dispatches, wall_ratio=ref_wall / rec["wall_s"])
        log(f"fleet (b) {dt}: the per-chip ContinuousBatchingEngines on the same streams in turn: {ref_disp} decode "
            f"dispatches in {ref_wall:.3f} s; dispatch amortization {rec['dispatch_amortization']:.2f}x, wall "
            f"{rec['wall_ratio']:.2f}x")
        if dt == "float32":
            parted, err = [], 0.0
            for c in range(n_b):
                for rid, o in ref_outs[c].items():
                    f = outs[c][rid]
                    a, b = seq_of(c, rid, o), seq_of(c, rid, f)
                    p = near_tie("(b) float32", c_cfg, c, ctxs_b[c], a, b, len(traffic[c][rid][1]))
                    upto = len(o.tokens) if p is None else p["at"] + 1
                    if p is not None:
                        parted.append(dict(p, rid=rid))
                    d = np.abs(f.logprobs[:upto] - o.logprobs[:upto])
                    err = max(err, float(d.max()))
                    if not bool((d <= atol32 + rtol32 * np.abs(o.logprobs[:upto])).all()):
                        raise Failed(f"fleet (b) float32 chip {c} request {rid}: logprobs differ from its own "
                                     f"engine's by {float(d.max()):.3g}")
            rec.update(logprob_err=err, parted=parted)
            log(f"fleet (b) float32: every chip against its own ContinuousBatchingEngine: logprob max err "
                f"{err:.3g}; tokens equal but {len(parted)} near-ties {parted}")
        else:
            anchors = []
            for c in range(n_b):
                served, lp16, lp32 = [], [], []
                for rid, o in outs[c].items():
                    start = len(traffic[c][rid][1])
                    seq = torch.as_tensor(seq_of(c, rid, o)[None], device=dev)
                    ctx_f = from_fault_map(maps[c], "fap", device=dev)
                    lp16.append(chosen(forced(cfg, params[c], ctx_f, seq, start), seq, start)[0])
                    lp32.append(chosen(forced(cfg32, params[c], ctx_f, seq, start), seq, start)[0])
                    served.append(torch.as_tensor(o.logprobs, device=dev))
                s, p16, p32 = torch.cat(served), torch.cat(lp16), torch.cat(lp32)
                plain = float((p16 - p32).pow(2).mean().sqrt())
                got_rms = float((s - p32).pow(2).mean().sqrt())
                anchors.append((plain, got_rms))
                if not bool(torch.isfinite(s).all()) or got_rms > ANCHOR_RATIO * plain:
                    raise Failed(f"fleet (b) bf16 chip {c}: served logprobs RMS err {got_rms:.4g} against plain "
                                 f"float32, more than {ANCHOR_RATIO} x plain bf16's {plain:.4g}")
            rec.update(anchors=anchors)
            outs_b16 = outs
            log(f"fleet (b) bf16: logprob RMS err against plain float32, (plain bf16, served) per chip: "
                + ", ".join(f"{a[0]:.4g}/{a[1]:.4g}" for a in anchors) + f" (served <= {ANCHOR_RATIO} x plain)")
            if profile:
                from torch.profiler import ProfilerActivity, profile as torch_profile

                t0 = time.perf_counter()
                eng.serve(streams)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                    eng.serve(streams)
                    torch.cuda.synchronize()
                busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
                rec["profile"] = dict(wall_ms=wall_ms, busy_ms=busy_ms, busy_share=busy_ms / wall_ms)
                log(f"fleet (b) bf16 profile ({card}): untraced wall {wall_ms:.2f} ms, traced device time "
                    f"{busy_ms:.2f} ms, busy {busy_ms / wall_ms:.1%}")
        report["b"][dt] = rec
        del eng

    # -- (b) probes: a control run, then one chip's silicon changes --------------------
    ctl, outs_ctl, stats_ctl, report["b"]["control"] = timed("(b) control", run_b, cfg, "(b) bf16 probes", probe=True)
    same = all(np.array_equal(outs_ctl[c][r].tokens, outs_b16[c][r].tokens)
               and np.array_equal(outs_ctl[c][r].logprobs, outs_b16[c][r].logprobs)
               for c in range(n_b) for r in outs_b16[c])
    if ctl.health.detections or not same or not stats_ctl.probe_dispatches:
        raise Failed(f"fleet (b) control: detections {ctl.health.detections}, bits as the run without probes "
                     f"{same}, probes {stats_ctl.probe_dispatches}")
    inj, outs_inj, _, report["b"]["inject"] = timed("(b) inject", run_b, cfg, "(b) bf16 injected", probe=True, inject=True)
    bound = FLEET_INJECT_AT + FLEET_PROBE_EVERY * (hc.suspect_after + 1)
    at, delta = inj.health.detected_at(FLEET_VICTIM), inj.health.last_delta(FLEET_VICTIM)
    fired = inj.alerts.summary()["fired"]
    others = [c for c in range(n_b) if c != FLEET_VICTIM]
    quiet = all(inj.health.state(c) == HEALTHY and inj.health.last_delta(c) is None for c in others)
    kept = all(np.array_equal(outs_inj[c][r].tokens, outs_ctl[c][r].tokens) for c in others for r in outs_ctl[c])
    report["b"]["inject"].update(
        detected_at=at, bound=bound, victim_state=inj.health.state(FLEET_VICTIM),
        delta_faults=int(delta.sum()) if delta is not None else 0, true_new_faults=int(true_new.sum()),
        others_quiet=quiet, others_tokens_as_control=kept, fired=fired, detections=inj.health.detections,
    )
    log(f"fleet (b) injected on chip {FLEET_VICTIM} at dispatch {FLEET_INJECT_AT}: detected at {at} (bound {bound}), "
        f"state {inj.health.state(FLEET_VICTIM)}, delta {report['b']['inject']['delta_faults']} PEs of "
        f"{int(true_new.sum())} new faults; chips {others} quiet {quiet}, tokens as the control run {kept}; "
        f"detections {inj.health.detections}; alerts fired {fired}")
    if (at is None or at > bound or inj.health.state(FLEET_VICTIM) == HEALTHY or delta is None
            or not delta.any() or (delta & ~true_new).any() or not quiet or not kept
            or inj.health.detections != 1 or "detect.new_faults" not in fired):
        raise Failed(f"fleet (b): the injection was not detected on chip {FLEET_VICTIM} alone: {report['b']['inject']}")
    del ctl, inj, outs_ctl, outs_inj, outs_b16

    # -- (c) the chip-batched masked GEMM against its plain version at every shape the
    # phase's dispatches give it: (a)'s decode (M = 4) and prefill (M = 512) and (b)'s
    # decode over its slots, in bf16 (decode and mma) and float32 (v1), the layers'
    # weights row-major and the tied unembed's embed.T k-contiguous --------------------
    flush = torch.empty(2**28, dtype=torch.int32, device=dev)
    oks = torch.stack([from_fault_map(maps[c], "kernel", device=dev).ok for c in range(FLEET_CHIPS)])
    ok_list = list(oks.unbind(0))  # one lasting tensor per chip: each packs its bits once

    def fleet_operands(dtype, m, k_, n_):
        """FLEET_CHIPS chips' x (dtype) and fp32 master w, embed.T read in place."""
        g = torch.Generator(device=dev).manual_seed(k_ + n_ + m)
        x = torch.randn(FLEET_CHIPS, m, k_, generator=g, device=dev).to(dtype)
        w = torch.randn(FLEET_CHIPS, n_, k_, generator=g, device=dev) / k_ ** 0.5
        return x, (w.transpose(1, 2) if n_ == cfg.vocab_size else w.transpose(1, 2).contiguous())

    fleet_err, parity = dict.fromkeys(("decode", "mma", "v1"), 0.0), []
    t0 = time.perf_counter()
    for dtype in (torch.bfloat16, torch.float32):
        rtol, atol = dtype_tol(dtype)
        for m in (BATCH, FLEET_ENGINE["num_slots"], BATCH * PROMPT):
            kind = pick_variant(dtype, m)
            for k_, n_, _ in cfg.gemm_shapes():
                x, w = fleet_operands(dtype, m, k_, n_)
                before = masked_matmul.fleet_launches_by_variant[kind]
                got = masked_matmul(x, w, oks).float()
                ran = masked_matmul.fleet_launches_by_variant[kind] - before
                ref = masked_matmul_ref(x, w, oks).float()
                err = float((got - ref).abs().max())
                fleet_err[kind] = max(fleet_err[kind], err)
                parity.append(dict(dtype=str(dtype).split(".")[-1], m=m, k=k_, n=n_, variant=kind,
                                   k_contiguous=w.stride(1) == 1, max_abs_err=err))
                if ran != 1 or not bool(((got - ref).abs() <= atol + rtol * ref.abs()).all()):
                    raise Failed(f"fleet (c): chip-batched masked GEMM, {dtype} x at M={m} ({k_}, {n_}): "
                                 f"{ran} chip-batched {kind} launches (expected 1), max err {err:.3g} against "
                                 f"the plain version (rtol {rtol}, atol {atol})")
                del x, w, got, ref
    stages["(c) chip-batched GEMM parity"] = time.perf_counter() - t0
    log(f"fleet (c) chip-batched masked GEMM against its plain version, {FLEET_CHIPS} chips, fp32 master w "
        f"(embed.T k-contiguous), at M = {BATCH}, {FLEET_ENGINE['num_slots']} and {BATCH * PROMPT}: max err by "
        f"variant {fleet_err} (bf16 x: decode, mma; float32 x: v1; each within dtype_tol of its dtype)")

    # -- (c) its time against its bound, one chip at a time and bmm --------------------
    gemm = {}
    t0 = time.perf_counter()
    for m in (BATCH, BATCH * PROMPT):
        rows = []
        for k_, n_, uses in cfg.gemm_shapes():
            x, w = fleet_operands(torch.bfloat16, m, k_, n_)
            wm = (w.to(torch.bfloat16).float() * periodic_mask(w.shape, oks)).to(torch.bfloat16)
            chip_bytes = 4 * k_ * n_ + 2 * m * k_ + 2 * m * n_ + rows_ * -(-cols_ // 8)
            ops = 2 * m * k_ * n_
            bytes_ms = FLEET_CHIPS * chip_bytes / HBM_BYTES_PER_S * 1e3
            ops_ms = FLEET_CHIPS * ops / PEAK_OPS["bfloat16"] * 1e3
            rows.append(dict(
                k=k_, n=n_, uses=uses,
                ms=event_ms(torch, lambda: masked_matmul(x, w, oks), flush),
                singles_ms=event_ms(torch, lambda: [masked_matmul(x[c], w[c], ok_list[c]) for c in range(FLEET_CHIPS)],
                                    flush),
                library_ms=event_ms(torch, lambda: torch.bmm(x, wm), flush),
                plain_ms=event_ms(torch, lambda: masked_matmul_ref(x, w, oks), flush, reps=3),
                bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
            ))
            del x, w, wm
        step = {key: sum(r[key] * r["uses"] for r in rows) for key in rows[0] if key.endswith("ms")}
        step["bound_by"] = "bytes" if step["bytes_ms"] >= step["ops_ms"] else "operations"
        step["max_abs_err"] = fleet_err[pick_variant(torch.bfloat16, m)]
        gemm[m] = dict(step=step, rows=rows)
        log(f"fleet (c) chip-batched masked GEMM ({card}), {FLEET_CHIPS} chips, bf16 x, fp32 master read in place, "
            f"one {'decode step' if m == BATCH else 'prefill'}'s {per_step} launches at M={m}: {step['ms']:.4f} ms "
            f"(bound {step['bound_ms']:.4f} ms by {step['bound_by']}: the chips' bytes {step['bytes_ms']:.4f}, "
            f"operations {step['ops_ms']:.4f}); the same launches one chip at a time {step['singles_ms']:.4f} ms; "
            f"torch.bmm on pre-masked bf16 w {step['library_ms']:.4f} ms; plain {step['plain_ms']:.4f} ms")
    stages["(c) chip-batched GEMM timing"] = time.perf_counter() - t0
    del flush, oks, ok_list, models, params
    gc.collect()
    torch.cuda.empty_cache()

    # -- (d) the families under the chip axis: hymba's scan, mixtral's experts --------
    t0 = time.perf_counter()
    report["d"] = fleet_families(torch, log, card)
    stages["(d) hymba and mixtral fleets"] = time.perf_counter() - t0
    report.update(gemm={str(m): v for m, v in gemm.items()}, parity=parity, max_abs_err=fleet_err,
                  launches_fleet=fleet_totals, stages=stages, seconds=time.perf_counter() - t_phase)
    log(f"fleet phase ({card}): {report['seconds']:.2f} s; stages (s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()) + f"; chip-batched launches {fleet_totals}")
    return report


FLEET_FAMILY_NEW = 16  # (d): greedy new tokens a family fleet generates
# (d): (config, chips, depth or None, why); chips random_fault_map(c, 256, 256, 0.05 * c), chip 0 healthy
FLEET_FAMILIES = (
    ("hymba-1.5b", 4, None, "all 32 layers: 1.52 B fp32 parameters a chip"),
    ("mixtral-8x22b", 2, 1, "8 experts x 3 x 6144 x 16384, attention, embedding and head: 11.6 GB of fp32 "
                            "master a chip, stacked once more by the engine"),
)
FLEET_EXPERT_MS = (8, 160)  # mixtral's chip x expert GEMMs: a decode step (4 x cap 2) and the prefill (4 x cap 40)
FLEET_TIE_ULPS = 8  # a bf16 fleet token may part from its chip's ServeEngine where the logits lie this many ulps apart


def fleet_families(torch, log, card):
    """Stage (d) of phase 14: the families the fleet engines took last, at
    full width in bf16 and ``kernel`` mode (FLEET_FAMILIES, each with its
    cut and reason): hymba-1.5b's scan and mixtral-8x22b's experts under the
    chip axis. Chips ``random_fault_map(c, 256, 256, 0.05 * c)``, chip 0
    healthy, params from seed 0 (hymba: seed c // 2, its A and D set apart
    by seed, which ``init_params`` does not do); the four 128-token prompts
    of ``default_rng(0)`` shared, FLEET_FAMILY_NEW greedy tokens through
    ``FleetServeEngine``. Returns the stage's report; raises ``Failed`` on a
    missed gate.

    Gates: every chip's served logprobs anchored as in (a) (RMS error
    against the plain float32 path, replayed through ``prefill`` and
    ``decode_step`` on the served tokens so that an MoE layer routes as the
    run did, at most ANCHOR_RATIO times plain bf16's own); each chip held to
    its own ``ServeEngine`` (exact-length prefill): tokens equal until a
    parting, and at a parting the two tokens' logits, in the engine's own
    kernel-mode replay, a bf16 near-tie apart: at most FLEET_TIE_ULPS units
    in the last place of the larger logit. The chip-batched launches split
    K otherwise than one chip's, and bf16 rounds the two sums apart through
    every layer, so a near-tie may fall the other way; the 4 units of
    ``examples/fleet_serve.py``'s rule for SmolLM's 30 layers parted
    hymba's 32 at 5. The faulty chips' tokens differ from chip 0's. Every
    masked
    GEMM of the run is one chip-batched launch, a step's count that of one
    chip (hymba 353; mixtral 9 at depth 1, its 3 expert GEMMs a step chip x
    expert launches), and every scan one launch over chips x rows (hymba's
    prefill: 32, whatever the chip count). Then the kernels against their
    plain versions on the run's own weights: the chip x expert GEMM on the
    engine's stacked ``wg`` and ``wd`` of layer 0 (a view of the stacked
    fp32 master, one mask a chip; each chip past the first scaled by
    1 + c, as the chips share one init) at M = FLEET_EXPERT_MS a expert in bf16
    (decode, mma) and float32 (v1), within ``dtype_tol``, timed beside its
    bound, ``torch.bmm`` on pre-masked w and the plain version; the
    chip-batched scan at hymba's prefill (4 chips x 4 x 128 x 3200 x 16) with
    each chip's own a and d (the engine's layer 0, chip c's A scaled by 1 +
    0.1 c and its D raised by 0.1 c), and with one a and d shared (chip
    stride 0), in bf16 and float32 at the scan rows' tolerances, timed beside its
    bound (the exponentials on the SFUs) and the plain version."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core import from_fault_map, healthy, random_fault_map
    from repro_torch.core.mapping import periodic_mask
    from repro_torch.fleet import FleetServeEngine
    from repro_torch.kernels.common import dtype_tol
    from repro_torch.kernels.mamba_scan.ops import selective_scan, selective_scan_ref
    from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_ref, pick_variant
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    dev = torch.device("cuda")
    new = FLEET_FAMILY_NEW
    flush = torch.empty(2**28, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    report = dict(models={}, expert_rows=[], scan_rows=[], launches={}, max_abs_err={}, seconds={})

    def replay(c, params, ctx, prompts, feed):
        """Logit rows (B, 1 + steps, V) of a served run, float32: ``prefill``
        of the prompts, then one ``decode_step`` per fed token."""
        with torch.no_grad():
            logits, cache = M.prefill(params, {"tokens": prompts}, c, ctx, cache_len=PROMPT + new, attn_impl="dense")
            rows = [logits.float()]
            for i in range(feed.shape[1]):
                step, cache = M.decode_step(params, feed[:, i:i + 1], cache, c, ctx)
                rows.append(step[:, 0].float())
        return torch.stack(rows, 1)

    def chosen(rows, toks):
        return torch.log_softmax(rows, -1).gather(-1, toks[..., None])[..., 0]

    def launch_counts():
        return dict(variants=dict(masked_matmul.launches_by_variant),
                    fleet=dict(masked_matmul.fleet_launches_by_variant),
                    fleet_experts=dict(masked_matmul.fleet_expert_launches_by_variant),
                    experts=dict(masked_matmul.expert_launches_by_variant),
                    scan=selective_scan.launches, scan_fleet=selective_scan.fleet_launches)

    def serve(c, chips, params, maps):
        """The fleet run and its gates; returns (engine, report)."""
        prompts = torch.as_tensor(np.random.default_rng(0).integers(0, c.vocab_size, (BATCH, PROMPT)), device=dev)
        ctxs = [healthy() if i == 0 else from_fault_map(maps[i], "kernel", device=dev) for i in range(chips)]
        plain_ctxs = [healthy() if i == 0 else from_fault_map(maps[i], "fap", device=dev) for i in range(chips)]
        eng = FleetServeEngine(c, params, ctxs, max_len=PROMPT + new)
        eng.generate(prompts[:, :16], max_new_tokens=2)  # warm-up, not counted
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launch_counts()
        per_step = sum(u for _, _, u in c.gemm_shapes())
        experts = 3 * c.num_layers * (1 + new) if c.has_moe else 0
        scans = c.num_layers if c.has_ssm else 0
        total = sum(got["variants"].values())
        batched = {k: got["fleet"][k] + got["fleet_experts"][k] for k in got["variants"]}
        if (total != per_step * (1 + new) or batched != got["variants"] or got["variants"]["v1"]
                or sum(got["fleet_experts"].values()) != experts or sum(got["experts"].values())
                or got["scan"] != scans or got["scan_fleet"] != scans):
            raise Failed(f"fleet (d) {c.name}: launches {got}; expected {per_step} chip-batched masked GEMMs a "
                         f"step ({experts} chip x expert in all), no v1, {scans} chip-batched scans")
        toks = out.tokens.cpu().numpy()
        for i in range(1, chips):
            if np.array_equal(toks[i, :, PROMPT:], toks[0, :, PROMPT:]):
                raise Failed(f"fleet (d) {c.name}: chip {i} (rate {0.05 * i:.2f}) gives chip 0's tokens")
        c32 = dataclasses.replace(c, dtype="float32")
        anchors, parted = [], []
        t1 = time.perf_counter()
        for i in range(chips):
            gen_t = out.tokens[i, :, PROMPT:]
            feed = gen_t[:, :-1]
            lp32 = chosen(replay(c32, params[i], plain_ctxs[i], prompts, feed), gen_t)
            lp16 = chosen(replay(c, params[i], plain_ctxs[i], prompts, feed), gen_t)
            plain = float((lp16 - lp32).pow(2).mean().sqrt())
            served = float((out.logprobs[i].float() - lp32).pow(2).mean().sqrt())
            anchors.append((plain, served))
            if not bool(torch.isfinite(out.logprobs[i]).all()) or served > ANCHOR_RATIO * plain:
                raise Failed(f"fleet (d) {c.name} chip {i}: served logprobs RMS err {served:.4g} against plain "
                             f"float32, more than {ANCHOR_RATIO} x plain bf16's {plain:.4g}")
            ref = ServeEngine(c, params[i], ctxs[i], max_len=PROMPT + new, prefill_buckets=None).generate(
                prompts, max_new_tokens=new)
            ref_t = ref.tokens[:, PROMPT:]
            own = None  # the engine's own kernel-mode replay, made at the chip's first parting
            for b in range(BATCH):
                diff = np.flatnonzero(ref_t[b].cpu().numpy() != toks[i, b, PROMPT:])
                if not diff.size:
                    continue
                at = int(diff[0])
                own = replay(c, params[i], ctxs[i], prompts, ref_t[:, :-1]) if own is None else own
                pair = (float(own[b, at, ref_t[b, at]]), float(own[b, at, int(toks[i, b, PROMPT + at])]))
                tie = FLEET_TIE_ULPS * 2.0 ** (np.floor(np.log2(max(map(abs, pair)))) - 7)
                parted.append(dict(chip=i, row=b, at=at, gap=abs(pair[0] - pair[1]), tie=tie, logits=pair,
                                   lp_err_before=float((out.logprobs[i, b, :at] - ref.logprobs[b, :at]).abs().max())
                                   if at else 0.0))
            del ref, own
        far = [p for p in parted if p["gap"] > p["tie"]]
        rec = dict(wall_s=wall, tokens_per_s=chips * BATCH * new / wall, ms_per_dispatch=wall / (1 + new) * 1e3,
                   launches=got, anchors=anchors, parted=parted, gates_s=time.perf_counter() - t1)
        log(f"fleet (d) {c.name} bf16 ({card}): {chips} chips x {BATCH} prompts x {new} tokens in {wall:.3f} s "
            f"({rec['tokens_per_s']:.1f} tokens/s, {rec['ms_per_dispatch']:.2f} ms a fused dispatch, prefill "
            f"included); launches {got} ({per_step} chip-batched masked GEMMs a step, {experts} chip x expert, "
            f"{scans} chip-batched scans); logprob RMS err against plain float32, (plain bf16, served) per chip: "
            + ", ".join(f"{a[0]:.4g}/{a[1]:.4g}" for a in anchors)
            + f"; tokens as each chip's own ServeEngine but {len(parted)} partings {parted}")
        if far:
            raise Failed(f"fleet (d) {c.name}: tokens part from the chip's own ServeEngine where the two logits are "
                         f"more than {FLEET_TIE_ULPS} bf16 ulps apart: {far}")
        return eng, rec

    def timed_row(fn, plain, sides, reps=10):
        return dict(ms=event_ms(torch, fn, flush, reps), plain_ms=event_ms(torch, plain, flush, 3),
                    bound_ms=max(sides.values()), bound_by=max(sides, key=sides.get),
                    bytes_ms=sides["bytes"], **{f"{k}_ms": v for k, v in sides.items() if k != "bytes"})

    def expert_rows(eng, c, chips):
        """The chip x expert GEMM on the engine's stacked layer-0 experts,
        each chip's its own: the chips share one init, so chip c's are
        scaled by 1 + c in place, and a launch that reads another chip's
        weights or mask shows."""
        ok = eng.ctx.ok
        mask_bytes = chips * ok.shape[1] * -(-ok.shape[2] // 8)
        for wname in ("wg", "wd"):
            w32 = eng.params[f"layers.0.moe.{wname}"]  # (chips, E, K, N): the stacked master
            w32.mul_(torch.arange(1, chips + 1, dtype=w32.dtype, device=dev).view(chips, 1, 1, 1))
            _, e, k_, n_ = w32.shape
            for dtype in (torch.bfloat16, torch.float32):
                rtol, atol = dtype_tol(dtype)
                for m in FLEET_EXPERT_MS:
                    x = torch.randn(chips, e, m, k_, generator=gen, device=dev).to(dtype)
                    before = dict(masked_matmul.fleet_expert_launches_by_variant)
                    y = masked_matmul(x, w32, ok)
                    kind = pick_variant(dtype, m)
                    ran = masked_matmul.fleet_expert_launches_by_variant[kind] - before[kind]
                    ref = masked_matmul_ref(x, w32, ok)
                    err, good = worst(y, ref, (rtol, atol))
                    del y, ref
                    if ran != 1 or not good:
                        raise Failed(f"fleet (d) chip x expert masked GEMM {wname} {dtype} M={m}: {ran} launches "
                                     f"of {kind} (want 1), max err {err:.3g} (rtol {rtol}, atol {atol})")
                    report["max_abs_err"][kind] = max(report["max_abs_err"].get(kind, 0.0), err)
                    size = 2 if dtype == torch.bfloat16 else 4
                    nbytes = chips * e * (m * k_ + m * n_) * size + chips * e * k_ * n_ * 4 + mask_bytes
                    sides = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                             "operations": 2 * chips * e * m * k_ * n_ / PEAK_OPS[str(dtype)[6:]] * 1e3}
                    wm = (w32 * periodic_mask(w32.shape, ok[:, None])).to(dtype).view(chips * e, k_, n_)
                    x3 = x.view(chips * e, m, k_)
                    row = dict(label=f"{c.name} {wname}", variant=kind, dtype=str(dtype)[6:], chips=chips, experts=e,
                               m=m, k=k_, n=n_, max_abs_err=err,
                               library_ms=event_ms(torch, lambda: torch.bmm(x3, wm), flush),
                               **timed_row(lambda: masked_matmul(x, w32, ok), lambda: masked_matmul_ref(x, w32, ok),
                                           sides))
                    report["expert_rows"].append(row)
                    log(f"fleet (d) chip x expert masked GEMM {row['label']} {row['dtype']:8s} {chips} chips x "
                        f"E={e} M={m:3d} K={k_:5d} N={n_:5d} ({card}): err<= {err:.3g} (rtol, atol {(rtol, atol)}) "
                        f"{kind} {row['ms']:.4f} ms, one launch (fp32 master in place, one mask a chip)  plain "
                        f"{row['plain_ms']:.4f} ms  torch.bmm(pre-masked w, library yardstick) "
                        f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
                    del x, x3, wm
                    gc.collect()
                    torch.cuda.empty_cache()

    def scan_rows(eng, c, chips):
        """The chip-batched scan at the prefill's shape with each chip's own
        a and d (the engine's layer 0, set apart further by chip), and with
        one a and d shared."""
        apart = 0.1 * torch.arange(chips, dtype=torch.float32, device=dev)
        a_all = -torch.exp(eng.params["layers.0.ssm.a_log"].float()) * (1 + apart)[:, None, None]  # (chips, D, N)
        d_all = eng.params["layers.0.ssm.d_skip"].float() + apart[:, None]
        _, dim, n = a_all.shape
        rows_ = chips * BATCH
        for u_dtype in (torch.bfloat16, torch.float32):
            u = torch.randn(rows_, PROMPT, dim, generator=gen, device=dev).to(u_dtype)
            dt = torch.nn.functional.softplus(torch.randn(rows_, PROMPT, dim, generator=gen, device=dev) - 3.0)
            dbc = torch.randn(rows_, PROMPT, 8 + 2 * n, generator=gen, device=dev).to(u_dtype)
            _, bm, cm = torch.split(dbc, [8, n, n], dim=-1)
            for share in ("per-chip", "shared"):
                a, d = (a_all, d_all) if share == "per-chip" else \
                    (a_all[1].expand(chips, dim, n), d_all[1].expand(chips, dim))
                args = (u, dt, a, bm, cm, d)
                before = selective_scan.fleet_launches
                y, h = selective_scan(*args)
                ran = selective_scan.fleet_launches - before
                ref_y, ref_h = selective_scan_ref(*args)
                y_tol = SCAN_F32_TOL if u_dtype == torch.float32 else \
                    (2e-2, 1e-2 * float(ref_y.float().pow(2).mean().sqrt()))
                y_err, y_good = worst(y, ref_y, y_tol)
                h_err, h_good = worst(h, ref_h, SCAN_F32_TOL)
                del y, h, ref_y, ref_h
                if ran != 1 or not (y_good and h_good):
                    raise Failed(f"fleet (d) chip-batched scan {share} {u_dtype}: {ran} launches (want 1), y err "
                                 f"{y_err:.3g} (tol {y_tol}), h err {h_err:.3g} (tol {SCAN_F32_TOL})")
                report["max_abs_err"]["scan"] = max(report["max_abs_err"].get("scan", 0.0), y_err, h_err)
                size = 2 if u_dtype == torch.bfloat16 else 4
                elems = rows_ * PROMPT * dim * n
                nbytes = (rows_ * PROMPT * dim * (2 * size + 4) + 2 * rows_ * PROMPT * n * size
                          + chips * (dim * n * 4 + dim * 4) + rows_ * dim * n * 4)
                sides = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": 7 * elems / PEAK_OPS["float32"] * 1e3,
                         "exps": elems / SFU_PER_S * 1e3}
                row = dict(share=share, dtype=str(u_dtype)[6:], chips=chips, b=BATCH, l=PROMPT, d=dim, n=n,
                           y_err=y_err, h_err=h_err, y_tol=y_tol, plan=selective_scan.last_plan._asdict(),
                           **timed_row(lambda: selective_scan(*args), lambda: selective_scan_ref(*args), sides))
                report["scan_rows"].append(row)
                log(f"fleet (d) chip-batched scan {share:8s} a/d {row['dtype']:8s} {chips} chips x {BATCH}x{PROMPT}x"
                    f"{dim}x{n} ({card}): y err {y_err:.3g} (tol {y_tol[0]}, {y_tol[1]:.3g}), h err {h_err:.3g}; "
                    f"one launch, {row['plan']['lanes']} lanes x {row['plan']['states']} states, "
                    f"{row['plan']['blocks']} blocks; {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}; bytes {sides['bytes']:.4f}, exps "
                    f"{sides['exps']:.4f})")
            del u, dt, dbc, bm, cm

    for name, chips, depth, why in FLEET_FAMILIES:
        t0 = time.perf_counter()
        c = get_arch(name)
        if depth is not None:
            c = dataclasses.replace(c, num_layers=depth)
        log(f"fleet (d) {name}: depth {c.num_layers} of {get_arch(name).num_layers}, full width ({why})")
        maps = [random_fault_map(i, c.array_rows, c.array_cols, 0.05 * i) for i in range(chips)]
        seeds = sorted({i // 2 if c.has_ssm else 0 for i in range(chips)})
        models = {s: M.init_params(c, s, device=dev) for s in seeds}
        with torch.no_grad():  # init_params' A and D do not depend on the seed: set each seed's apart
            for s, model in models.items():
                for pname, p in model.named_parameters():
                    if pname.endswith(("ssm.a_log", "ssm.d_skip")):
                        p.add_(0.1 * s)
        params = [models[i // 2 if c.has_ssm else 0] for i in range(chips)]
        eng, report["models"][name] = serve(c, chips, params, maps)
        report["launches"][name] = report["models"][name]["launches"]
        del models, params
        gc.collect()
        torch.cuda.empty_cache()
        if c.has_moe:
            expert_rows(eng, c, chips)
        if c.has_ssm:
            scan_rows(eng, c, chips)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        report["seconds"][name] = time.perf_counter() - t0
    del flush
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 15: the rest of the model zoo at full width
# ---------------------------------------------------------------------------

ZOO_NEW = 16  # greedy new tokens a zoo serve generates
ZOO_FRAMES = 1024  # hubert-xlarge's frames a sequence
ZOO_EXPERT_MS = (8, 160)  # mixtral's expert GEMMs: a decode step (4 x cap 2) and its serving prefill (4 x cap 40)
# depth cuts, each forced by one card's 80 GB (fp32 master weights)
ZOO_DEPTH = {
    "mixtral-8x22b": (4, "8 experts x 3 x 6144 x 16384 and attention: 2.50 B parameters, 10.1 GB of fp32 "
                         "master a layer; all 56 layers would be 564 GB"),
    "internvl2-26b": (12, "1.57 GB of fp32 master a layer; all 48 layers and the 4.5 GB embedding and head "
                          "would leave no room for the plain gate's masked copies"),
}


def zoo_phase(torch, log):
    """The MoE, encoder and vision members of the reference's model zoo on
    the card at full published width, random weights from seed 0, on
    ``random_fault_map(0, 256, 256, 0.1)`` in ``kernel`` mode; returns the
    phase's report and raises ``Failed`` on a missed gate. (qwen3-0.6b, a
    dense decoder, takes phases 6 and 7's gates in ``run``, and llama3-405b's
    GEMMs phase 2's.)

    Every model is gated against the plain path (``fap`` context, dense
    attention) on the same inputs: float32 elementwise at ``dtype_tol(
    float32, atol_scale=50)``, bf16 anchored (its relative L2 error against
    the plain float32 path, and the served logprobs' RMS error, at most
    ANCHOR_RATIO times plain bf16's own). The decoders' gates replay the
    run's tokens through ``prefill`` and ``decode_step`` as ``ServeEngine``
    runs them: an MoE layer's capacity depends on the sequence length, so a
    teacher-forced forward would route other tokens. A bf16
    kernel-mode run must cast no weight to bf16 (``weight_cast_watch``),
    launch no v1, and a float32 one only v1.

    (a) mixtral-8x22b, depth ZOO_DEPTH (printed with its reason), through
    ``ServeEngine`` in bf16 and float32: 4 x 128-token prompts, ZOO_NEW
    greedy tokens; 4 x (4 attention + the router + 3 expert GEMMs) + the
    unembed = 33 masked-GEMM launches a step (``gemm_shapes``), 12 of them
    expert-batched (``masked_matmul.expert_launches_by_variant``). Then the
    expert-batched GEMM on layer 0's own ``wg`` (8, 6144, 16384) and ``wd``
    (8, 16384, 6144) under the one mask, at M = 8 and 160 a expert, bf16 x
    on the fp32 master (decode, mma; bit-equal to the bf16-w launch) and
    float32 (v1), held to its plain version at ``dtype_tol`` and timed
    beside its bound, ``torch.bmm`` on pre-masked weights (the library
    yardstick) and the plain version.
    (b) hubert-xlarge, all 48 layers: ``forward`` on random (4, 1024, 512)
    frames from ``default_rng(0)`` in bf16 and float32, flash non-causal at
    D = 80, 290 masked GEMMs and 48 flash launches; ``ServeEngine`` must
    refuse it.
    (c) internvl2-26b, depth ZOO_DEPTH: ``prefill`` of 4 requests of 256
    random patch embeddings (width 1024) and 128 tokens, then ZOO_NEW greedy
    ``decode_step``s, in bf16."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core import from_fault_map, random_fault_map
    from repro_torch.core.mapping import periodic_mask
    from repro_torch.kernels.common import dtype_tol
    from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_ref, pick_variant
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.bucketing import ladder_rung

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    card = card_line()
    fm = random_fault_map(0, 256, 256, 0.1)
    ctx_k, ctx_f = from_fault_map(fm, "kernel", device=dev), from_fault_map(fm, "fap", device=dev)
    ok = ctx_k.ok
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(2**28, dtype=torch.int32, device=dev)
    mask_bytes = ok.shape[0] * -(-ok.shape[1] // 8)  # the mask bits every kernel reads
    report = dict(models={}, expert_rows=[], seconds={})
    totals = {}  # launches by counter, over the phase's main-path runs
    errs = {}  # the expert-batched GEMM's worst parity error by variant

    def counts():
        got = variant_counts()
        for k, n in got.items():
            totals[k] = totals.get(k, 0) + n
        return got

    def check(label, dtype, got, gemms, experts=0, flash=0):
        """The run's launches: ``gemms`` masked GEMMs (``experts`` of them
        expert-batched) and ``flash`` flash kernels, all of the dtype's own
        variants (v1 for float32 only)."""
        mm = sum(n for k, n in got.items() if k.startswith("masked_matmul.") and not k.endswith(".experts"))
        ex = sum(n for k, n in got.items() if k.endswith(".experts"))
        fa = sum(n for k, n in got.items() if k.startswith("flash_attention."))
        wrong = {k: n for k, n in got.items() if n and (".v1" in k) == (dtype == "bfloat16")}
        if (mm, ex, fa) != (gemms, experts, flash) or wrong:
            raise Failed(f"zoo {label} {dtype}: launches {mm} masked GEMMs ({ex} expert-batched), {fa} flash "
                         f"(want {gemms}, {experts}, {flash}); wrong kernels {wrong}")

    def watch_shapes(c):
        shapes = {sh for k_, n_, _ in c.gemm_shapes() for sh in ((k_, n_), (n_, k_))}
        if c.has_moe:
            shapes |= {(c.num_experts, c.d_model, c.d_ff), (c.num_experts, c.d_ff, c.d_model)}
        return shapes

    def no_casts(label, c, fn):
        """bf16 kernel mode reads the fp32 master in place: no weight is cast."""
        with weight_cast_watch(torch, watch_shapes(c)) as watch:
            fn()
            torch.cuda.synchronize()
        if watch.seen:
            raise Failed(f"zoo {label}: kernel mode cast GEMM weights to bf16: {watch.seen[:8]}")
        return len(watch.seen)

    def replay(c, params, ctx, batch, feed, **kw):
        """Logits of a served run's steps, float32 (B, 1 + steps, V):
        ``prefill`` as the run made it, then one ``decode_step`` per fed
        token (B, steps)."""
        with torch.no_grad():
            logits, cache = M.prefill(params, batch, c, ctx, **kw)
            rows = [logits.float()]
            for i in range(feed.shape[1]):
                step, cache = M.decode_step(params, feed[:, i:i + 1], cache, c, ctx)
                rows.append(step[:, 0].float())
        return torch.stack(rows, 1)

    def gate(label, c, params, batch, feed, tokens, got, served_lp=None, **kw):
        """The kernel path's step logits ``got`` (B, steps, V), which chose
        ``tokens`` (B, steps), and the served logprobs (those of ``got``
        where not given) against the plain path replayed on ``feed``."""
        def lp_of(rows):
            return torch.log_softmax(rows, -1).gather(-1, tokens[..., None])[..., 0]

        ref = replay(c, params, ctx_f, batch, feed, **kw)
        served = lp_of(got) if served_lp is None else served_lp.float()
        out = dict(logit_err=float((got - ref).abs().max()), ref_logit_rms=float(ref.pow(2).mean().sqrt()),
                   token_agreement=float((ref.argmax(-1) == tokens).float().mean()))
        if c.dtype == "float32":
            rtol, atol = dtype_tol(torch.float32, atol_scale=50.0)
            out.update(logprob_err=float((served - lp_of(ref)).abs().max()),
                       gate=f"float32 elementwise (rtol, atol) {(rtol, atol)}")
            if out["logprob_err"] > atol or not bool(((got - ref).abs() <= atol + rtol * ref.abs()).all()):
                raise Failed(f"zoo {label}: the kernel path disagrees with the plain path: {out}")
            return out
        ref32 = replay(dataclasses.replace(c, dtype="float32"), params, ctx_f, batch, feed, **kw)
        lp32 = lp_of(ref32)
        out.update(plain_rel_l2=rel_l2(ref, ref32), kernel_rel_l2=rel_l2(got, ref32),
                   plain_lp_rms=float((lp_of(ref) - lp32).pow(2).mean().sqrt()),
                   kernel_lp_rms=float((lp_of(got) - lp32).pow(2).mean().sqrt()),
                   served_lp_rms=float((served - lp32).pow(2).mean().sqrt()),
                   served_vs_kernel_replay=float((served - lp_of(got)).abs().max()), gate="bf16 anchored to float32")
        out["logit_ratio"] = out["kernel_rel_l2"] / out["plain_rel_l2"]
        out["logprob_ratio"] = out["served_lp_rms"] / out["plain_lp_rms"]
        if not bool(torch.isfinite(got).all()) or max(out["logit_ratio"], out["logprob_ratio"]) > ANCHOR_RATIO:
            raise Failed(f"zoo {label}: the kernel path is farther from the float32 plain path than the bf16 "
                         f"plain path is: {out}")
        return out

    def serve(c, params):
        """``ServeEngine`` on 4 x 128-token prompts, ZOO_NEW greedy tokens."""
        label = f"{c.name} {c.dtype}"
        per_step = sum(u for _, _, u in c.gemm_shapes())
        prompts = torch.randint(0, c.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
        eng = ServeEngine(c, params, ctx_k, max_len=None)
        eng.generate(prompts, max_new_tokens=2)  # warm-up, not counted
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new_tokens=ZOO_NEW)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = counts()
        experts = 3 * c.num_layers * (1 + ZOO_NEW)
        check(c.name, c.dtype, got, per_step * (1 + ZOO_NEW), experts)
        casts = no_casts(label, c, lambda: eng.generate(prompts, max_new_tokens=2)) \
            if c.dtype == "bfloat16" else None
        if out.tokens.shape != (BATCH, PROMPT + ZOO_NEW) or not bool(torch.isfinite(out.logprobs).all()):
            raise Failed(f"zoo serve {label}: bad output {tuple(out.tokens.shape)}")
        # the prompts padded as the engine pads them: an MoE layer routes the pad too
        cache_len = eng.cache_len_for(PROMPT, ZOO_NEW)
        width = min(ladder_rung(PROMPT, eng.prefill_buckets), cache_len)
        batch = {"tokens": torch.cat([prompts, prompts.new_zeros(BATCH, width - PROMPT)], 1)}
        kw = dict(cache_len=cache_len, valid_len=PROMPT)
        feed = out.tokens[:, PROMPT:PROMPT + ZOO_NEW - 1]
        kernel = replay(c, params, ctx_k, batch, feed, **kw)
        res = gate(label, c, params, batch, feed, out.tokens[:, PROMPT:], kernel, out.logprobs, **kw)
        res.update(tokens_per_s=BATCH * ZOO_NEW / dt, step_ms=dt / (1 + ZOO_NEW) * 1e3,
                   launches={k: n for k, n in got.items() if n}, launches_per_step=per_step, weight_casts=casts)
        log(f"zoo serve {label}: {BATCH}x{ZOO_NEW} tokens in {dt:.3f} s ({res['tokens_per_s']:.1f} tok/s, "
            f"{res['step_ms']:.2f} ms a step); launches {res['launches']} ({per_step} masked GEMMs a step, "
            f"{experts // (1 + ZOO_NEW)} of them expert-batched; fp32->bf16 weight casts "
            f"{'not checked' if casts is None else casts}); gate {res['gate']}: "
            + ", ".join(f"{k} {v:.4g}" for k, v in res.items() if isinstance(v, float)))
        return res

    def expert_row(label, x, w32, wm, reps=10):
        """Parity and times of one expert-batched launch: x (E, M, K) against
        w32 (E, K, N), the fp32 master (a bf16 x reads it in place), under
        the chip's one mask; ``wm`` is w pre-masked in x's dtype for
        ``torch.bmm``."""
        bf16 = x.dtype == torch.bfloat16
        got = masked_matmul(x, w32, ok)
        ref = masked_matmul_ref(x, w32, ok)
        err, good = worst(got, ref, dtype_tol(x.dtype))
        same_bits = None
        if bf16:  # the bf16 copy of w gives the same bits
            same_bits = bool(torch.equal(masked_matmul(x, w32.to(torch.bfloat16), ok), got))
        del got, ref
        e, m, k_ = x.shape
        n_ = w32.shape[-1]
        size = 2 if bf16 else 4
        nbytes = e * (m * k_ + m * n_) * size + e * k_ * n_ * 4 + mask_bytes
        sides = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "operations": 2 * e * m * k_ * n_ / PEAK_OPS["bfloat16" if bf16 else "float32"] * 1e3}
        row = dict(label=label, variant=pick_variant(x.dtype, m), dtype=str(x.dtype)[6:], experts=e, m=m, k=k_,
                   n=n_, max_abs_err=err, same_bits_as_bf16_w=same_bits,
                   ms=event_ms(torch, lambda: masked_matmul(x, w32, ok), flush, reps),
                   plain_ms=event_ms(torch, lambda: masked_matmul_ref(x, w32, ok), flush, 3),
                   library_ms=event_ms(torch, lambda: torch.bmm(x, wm), flush, reps),
                   bound_ms=max(sides.values()), bound_by=max(sides, key=sides.get),
                   bytes_ms=sides["bytes"], ops_ms=sides["operations"])
        errs[row["variant"]] = max(errs.get(row["variant"], 0.0), err)
        log(f"zoo masked_matmul {label} {row['dtype']:8s} E={e} M={m:4d} K={k_:5d} N={n_:6d}: err<= {err:.3g} "
            f"(rtol, atol {dtype_tol(x.dtype)}) {row['variant']} {row['ms']:.4f} ms (fp32 master in place; "
            f"bf16-w bits equal {same_bits}) plain {row['plain_ms']:.4f} ms  torch.bmm(pre-masked w, library "
            f"yardstick) {row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        if not good or same_bits is False:
            raise Failed(f"zoo masked_matmul {label} {row['dtype']} M={m}: err {err}, bf16-w bits equal {same_bits}")
        return row

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def cut(name):
        depth, why = ZOO_DEPTH[name]
        c = get_arch(name)
        log(f"zoo {name}: depth {depth} of {c.num_layers} ({why}); full width")
        return dataclasses.replace(c, num_layers=depth)

    def init(c):
        t0 = time.perf_counter()
        params = M.init_params(c, 0, device=dev)
        torch.cuda.synchronize()
        log(f"zoo {c.name}: {sum(p.numel() for p in params.parameters()) / 1e9:.3f} G fp32 parameters "
            f"initialized on the card in {time.perf_counter() - t0:.2f} s")
        return params

    # -- (a) mixtral-8x22b, depth 4 -------------------------------------------------
    t0 = time.perf_counter()
    mix = cut("mixtral-8x22b")
    params = init(mix)
    report["models"][mix.name] = {dt: serve(dataclasses.replace(mix, dtype=dt), params)
                                  for dt in ("bfloat16", "float32")}
    for wname in ("wg", "wd"):  # layer 0's own experts, (E, K, N) under the one mask
        w32 = getattr(params.layers[0].moe, wname).detach()
        e, k_, n_ = w32.shape
        for dtype in (torch.bfloat16, torch.float32):
            wm = (w32 * periodic_mask(w32.shape, ok)).to(dtype)
            for m in ZOO_EXPERT_MS:
                x = torch.randn(e, m, k_, generator=gen, device=dev).to(dtype)
                report["expert_rows"].append(expert_row(f"mixtral {wname}", x, w32, wm))
            del wm, x
            free()
    del params, w32
    free()
    report["seconds"][mix.name] = time.perf_counter() - t0

    # -- (b) hubert-xlarge, all 48 layers: the encoder ------------------------------
    t0 = time.perf_counter()
    hub = get_arch("hubert-xlarge")
    params = init(hub)
    try:
        ServeEngine(hub, params, ctx_k)
        raise Failed("zoo hubert-xlarge: ServeEngine served an encoder")
    except ValueError as e:
        refusal = str(e)
    frames = torch.as_tensor(np.random.default_rng(0).standard_normal((BATCH, ZOO_FRAMES, 512)), dtype=torch.float32,
                             device=dev)
    per_fwd = sum(u for _, _, u in hub.gemm_shapes())
    outs, runs = {}, {}
    with torch.no_grad():
        for dt in ("bfloat16", "float32"):
            c = dataclasses.replace(hub, dtype=dt)
            M.forward(params, {"embeds": frames[:, :128]}, c, ctx_k, attn_impl="kernel")  # warm-up
            torch.cuda.synchronize()
            reset_launches()
            t1 = time.perf_counter()
            outs[("kernel", dt)] = M.forward(params, {"embeds": frames}, c, ctx_k, attn_impl="kernel")[0].float()
            torch.cuda.synchronize()
            runs[dt] = dict(kernel_ms=(time.perf_counter() - t1) * 1e3)
            got = counts()
            check("hubert-xlarge forward", dt, got, per_fwd, flash=hub.num_layers)
            runs[dt]["launches"] = {k: n for k, n in got.items() if n}
            if dt == "bfloat16":
                runs[dt]["weight_casts"] = no_casts(
                    "hubert-xlarge", c, lambda: M.forward(params, {"embeds": frames[:, :128]}, c, ctx_k, attn_impl="kernel"))
            outs[("plain", dt)] = M.forward(params, {"embeds": frames}, c, ctx_f, attn_impl="dense")[0].float()
    rtol32, atol32 = dtype_tol(torch.float32, atol_scale=50.0)
    e32, good32 = worst(outs[("kernel", "float32")], outs[("plain", "float32")], (rtol32, atol32))
    hub_gate = dict(f32_max_abs=e32, f32_rel_l2=rel_l2(outs[("kernel", "float32")], outs[("plain", "float32")]),
                    plain_rel_l2=rel_l2(outs[("plain", "bfloat16")], outs[("plain", "float32")]),
                    kernel_rel_l2=rel_l2(outs[("kernel", "bfloat16")], outs[("plain", "float32")]))
    ratio = hub_gate["kernel_rel_l2"] / hub_gate["plain_rel_l2"]
    report["models"][hub.name] = dict(runs=runs, gate=hub_gate, ratio=ratio, serve_refusal=refusal)
    log(f"zoo hubert-xlarge forward {BATCH}x{ZOO_FRAMES} frames (flash non-causal at D={hub.resolved_head_dim}): "
        + "; ".join(f"{dt} kernel path {r['kernel_ms']:.2f} ms, launches {r['launches']}" for dt, r in runs.items())
        + f"; float32 max err {e32:.3g} (rtol, atol {(rtol32, atol32)}), rel L2 {hub_gate['f32_rel_l2']:.3g}; bf16 "
        f"rel L2 against plain float32: plain {hub_gate['plain_rel_l2']:.4g}, kernel {hub_gate['kernel_rel_l2']:.4g} "
        f"(ratio {ratio:.3f} <= {ANCHOR_RATIO}); ServeEngine refused it: {refusal!r}")
    if not good32 or hub_gate["f32_rel_l2"] > MAX_REL_L2 or ratio > ANCHOR_RATIO:
        raise Failed(f"zoo hubert-xlarge: the kernel path disagrees with the plain path: {hub_gate}")
    del params, frames, outs
    free()
    report["seconds"][hub.name] = time.perf_counter() - t0

    # -- (c) internvl2-26b, depth 12: the vision prefix ----------------------------
    t0 = time.perf_counter()
    vlm = cut("internvl2-26b")
    params = init(vlm)
    batch = {"embeds": torch.randn(BATCH, vlm.frontend_tokens, 1024, generator=gen, device=dev),
             "tokens": torch.randint(0, vlm.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)}
    seq = vlm.frontend_tokens + PROMPT
    kw = dict(cache_len=seq + ZOO_NEW)
    layer_gemms = sum(u for _, _, u in vlm.gemm_shapes()) - 1  # a decode step has no frontend
    small = {"embeds": batch["embeds"][:, :8], "tokens": batch["tokens"][:, :8]}
    replay(vlm, params, ctx_k, small, batch["tokens"][:, :2], cache_len=24)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    with torch.no_grad():
        logits, cache = M.prefill(params, batch, vlm, ctx_k, **kw)
        rows, fed = [logits.float()], []
        for _ in range(ZOO_NEW):
            fed.append(rows[-1].argmax(-1, keepdim=True))
            step, cache = M.decode_step(params, fed[-1], cache, vlm, ctx_k)
            rows.append(step[:, 0].float())
    torch.cuda.synchronize()
    vlm_ms = (time.perf_counter() - t1) * 1e3
    got = counts()
    check("internvl2-26b", "bfloat16", got, 1 + layer_gemms * (1 + ZOO_NEW))
    if cache["index"] != seq + ZOO_NEW:
        raise Failed(f"zoo internvl2-26b: cache index {cache['index']}, want {seq + ZOO_NEW}")
    casts = no_casts("internvl2-26b", vlm, lambda: replay(vlm, params, ctx_k, small, batch["tokens"][:, :2], cache_len=24))
    feed = torch.cat(fed, 1)
    kernel_rows = torch.stack(rows, 1)
    res = gate("internvl2-26b bfloat16", vlm, params, batch, feed[:, :-1], feed, kernel_rows[:, :-1], **kw)
    res.update(kernel_ms=vlm_ms, launches={k: n for k, n in got.items() if n}, weight_casts=casts)
    report["models"][vlm.name] = res
    log(f"zoo internvl2-26b bf16: prefill {BATCH} x ({vlm.frontend_tokens} patches + {PROMPT} tokens) and "
        f"{ZOO_NEW} greedy decode steps in {vlm_ms:.2f} ms; launches {res['launches']} (the frontend once, "
        f"{layer_gemms} a step); fp32->bf16 weight casts {casts}; gate {res['gate']}: "
        + ", ".join(f"{k} {v:.4g}" for k, v in res.items() if isinstance(v, float)))
    del params, batch, cache, logits, rows, kernel_rows
    free()
    report["seconds"][vlm.name] = time.perf_counter() - t0

    report.update(launches=totals, max_abs_err=errs, seconds_total=time.perf_counter() - t_phase,
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"zoo phase ({card}): {report['seconds_total']:.2f} s; by model (s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in report["seconds"].items())
        + f"; launches {({k: n for k, n in totals.items() if n})}")
    return report


def tune_spaces(torch, log, table, rec, dev):
    """Phase 5's cells of the masked GEMM, flash attention and the scan
    (``TUNE_CELLS``), tuned on ``dev`` from an empty cache into ``table``;
    then, with ``table`` installed as the process cache, each wrapper called
    with no blocks must launch the tuned blocks and match its plain version
    at ``dtype_tol``. Leaves ``table`` installed, saves it to
    ``build/tune_table.json`` and returns the rows, the tuner's launches by
    kernel variant and the worst errors; raises ``Failed`` on a missed gate."""
    from repro_torch.kernels.common import dtype_tol
    from repro_torch.kernels.flash_attention.ops import attention_ref, flash_attention
    from repro_torch.kernels.mamba_scan.ops import selective_scan, selective_scan_ref
    from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_ref
    from repro_torch.core import from_fault_map, random_fault_map
    from repro_torch.tune import TuningCache, set_tuning_cache, tune_many

    gen = torch.Generator(device=dev).manual_seed(5)
    ok = from_fault_map(random_fault_map(0, 256, 256, 0.1), "kernel", device=dev).ok
    t0 = time.perf_counter()
    set_tuning_cache(TuningCache(source="<chip_smoke: heuristic>"))
    space_launches = dict(variant_counts(), selective_scan=selective_scan.launches)
    space_results = []
    for kernel, shape, dname in TUNE_CELLS:
        res, table = tune_many([(kernel, shape)], cache=table, dtype=getattr(torch, dname), device=dev, recorder=rec)
        space_results += res
    if dev.type == "cuda":
        torch.cuda.synchronize()
    space_tune_s = time.perf_counter() - t0
    space_launches = {k: n - space_launches[k]
                      for k, n in dict(variant_counts(), selective_scan=selective_scan.launches).items()
                      if not k.endswith(".experts")}
    if dev.type == "cuda" and not all(space_launches[k] for k in (
            "masked_matmul.decode", "masked_matmul.mma", "masked_matmul.v1", "flash_attention.mma",
            "flash_attention.v1", "selective_scan")):
        raise Failed(f"tuner: a space left a kernel unlaunched: {space_launches}")
    rows = []
    for r in space_results:
        rows.append(dict(key=r.key, heuristic=r.heuristic_blocks, heuristic_us=r.heuristic_s * 1e6,
                         tuned=r.best_blocks, tuned_us=r.best_s * 1e6, speedup=r.speedup,
                         roofline_fraction=r.roofline_fraction, smem_bytes=r.smem_bytes, evaluated=r.evaluated,
                         rejected=r.rejected_configs))
        log(f"tune {r.key}: heuristic {r.heuristic_blocks} {r.heuristic_s * 1e6:.2f} us, tuned {r.best_blocks} "
            f"{r.best_s * 1e6:.2f} us (x{r.speedup:.3f}; H100 roofline fraction at the {r.dtype} peak "
            f"{r.roofline_fraction:.4f}; {r.smem_bytes} B shared memory); evaluated {r.evaluated}, rejected "
            f"{r.rejected} {[(tuple(x['blocks'].values()), x['codes']) for x in r.rejected_configs]}")

    def tuned_case(kernel, shape, dtype):
        """(kernel call with no blocks, its plain version, the launch's blocks) on seeded inputs."""
        if kernel == "masked_matmul":
            x = torch.randn(shape["m"], shape["k"], generator=gen, device=dev).to(dtype)
            w = torch.randn(shape["k"], shape["n"], generator=gen, device=dev) / shape["k"] ** 0.5  # fp32 master
            return (lambda: masked_matmul(x, w, ok), lambda: masked_matmul_ref(x, w, ok),
                    lambda: dict(splits=masked_matmul.last_splits))
        if kernel == "flash_attention":
            q = torch.randn(shape["b"], shape["hq"], shape["sq"], shape["d"], generator=gen, device=dev).to(dtype)
            k_, v_ = (torch.randn(shape["b"], shape["hkv"], shape["skv"], shape["d"], generator=gen,
                                  device=dev).to(dtype) for _ in range(2))
            causal = bool(shape["causal"])
            return (lambda: flash_attention(q, k_, v_, causal=causal),
                    lambda: attention_ref(q, k_, v_, causal=causal), lambda: dict(flash_attention.last_blocks))
        b, length, d, n = (shape[f] for f in ("b", "l", "d", "n"))
        args_ = (torch.randn(b, length, d, generator=gen, device=dev).to(dtype),
                 torch.nn.functional.softplus(torch.randn(b, length, d, generator=gen, device=dev)),
                 -torch.exp(torch.randn(d, n, generator=gen, device=dev)),
                 torch.randn(b, length, n, generator=gen, device=dev).to(dtype),
                 torch.randn(b, length, n, generator=gen, device=dev).to(dtype),
                 torch.randn(d, generator=gen, device=dev))
        return (lambda: selective_scan(*args_), lambda: selective_scan_ref(*args_),
                lambda: dict(lanes=selective_scan.last_plan.lanes))

    set_tuning_cache(table)
    space_err = {}
    for (kernel, shape, dname), r, row in zip(TUNE_CELLS, space_results, rows):
        dtype = getattr(torch, dname)
        run_kernel, run_plain, launched = tuned_case(kernel, shape, dtype)
        got, ref = run_kernel(), run_plain()
        row["launched"] = got_blocks = launched()
        if kernel == "mamba_scan":  # y in u's dtype, h_last in fp32
            err, good = worst(got[0], ref[0], dtype_tol(dtype))
            h_err, h_good = worst(got[1], ref[1], SCAN_F32_TOL)
            err, good = max(err, h_err), good and h_good
        else:
            err, good = worst(got, ref, dtype_tol(dtype))
        row["max_abs_err"] = err
        space_err[kernel] = max(space_err.get(kernel, 0.0), err)
        if got_blocks != r.best_blocks or not good:
            raise Failed(f"tuned {r.key}: launched {got_blocks}, table {r.best_blocks}, err {err} "
                         f"(rtol, atol {dtype_tol(dtype)})")
        log(f"tuned table in use, {r.key}: launched {got_blocks} with no blocks given, err<= {err:.3g} "
            f"(rtol, atol {dtype_tol(dtype)})")
        del got, ref, run_kernel, run_plain
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    table.save(str(OUT_DIR / "tune_table.json"))
    log(f"tuner over the masked GEMM, flash and the scan: {len(space_results)} cells tuned in {space_tune_s:.2f} "
        f"s, launches by kernel {space_launches}; with the tuned table's check {time.perf_counter() - t0:.2f} s; "
        f"the whole table ({len(table)} entries) saved to build/tune_table.json")
    return dict(rows=rows, launches=space_launches, max_abs_err=space_err, seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one bf16 serving run per model (build/profile_serve.txt)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script runs on a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        return fail(f"no src/repro_torch beside {Path(__file__).name}: run it from the repository")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        return run(args, torch)
    except Failed as e:
        return fail(str(e))


def run(args, torch) -> int:
    from repro_torch.analysis import analyze_stack, default_baseline_path, kernel_launches, lint_kernels, load_baseline
    from repro_torch.analysis.programs import sample_decode_spec
    from repro_torch.analysis.kernelgeom import decode_attention_launch
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.core import from_fault_map, random_fault_map
    from repro_torch.kernels.common import build_kernels, dtype_tol
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention.ops import attention_ref, flash_attention
    from repro_torch.kernels.mamba_scan.ops import selective_scan, selective_scan_ref
    from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_ref, packed_mask, pick_variant
    from repro_torch.models import model as M
    from repro_torch.models import ssm as ssm_module
    from repro_torch.obs.recorder import Recorder
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.kvcache import PageAllocator, chain_layout, pages_needed
    from repro_torch.tune import TuningCache, set_tuning_cache, tune_many
    from repro_torch.tune.search import pow2_lattice
    from repro_torch.tune.tuner import lint_candidate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        "plain fp32 matmuls without TF32")

    # ---- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    logs = build_kernels(["masked_matmul", "flash_attention", "selective_scan", "selective_scan_bwd", "decode_attention"])
    # kernel instances a source builds: the entry functions ptxas compiles
    instances = {name: text.count("Compiling entry function") for name, text in logs.items()}
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs) or 'cached'}; by source, nvcc's wall (s) and "
        "kernel instances: " + ", ".join(f"{n} {build_kernels.seconds[n]:.2f} ({instances[n]})" for n in sorted(logs)))
    for name, text in logs.items():  # ptxas's registers and spills, by kernel instance
        fn = ""
        for line in text.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:  # the mangled name without its anonymous namespace (_ZN<length><name>)
                fn = m.group(1)
                ns = re.match(r"_ZN(\d+)_GLOBAL__N_", fn)
                fn = fn[ns.end(1) + int(ns.group(1)):] if ns else fn
            elif "registers" in line or "spill" in line:
                log(f"  {name}: {fn}: {line.strip()}")

    # 1 GiB: overwriting it evicts the 50 MB L2 and keeps the card busy for about
    # 0.3 ms, longer than the host takes to enqueue the timed launch, so the
    # events below time the device alone
    flush = torch.empty(2**28, dtype=torch.int32, device=dev)

    def time_ms(fn, reps=10):
        """Median of single launches timed by CUDA events, each with the L2
        cache overwritten first, as a serving step finds it."""
        fn()
        times = []
        for _ in range(reps):
            flush.zero_()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def name_of(dtype):
        return str(dtype)[6:]

    failures = []
    cfg = get_arch("smollm-135m")
    falcon, hymba = get_arch("falcon-mamba-7b"), get_arch("hymba-1.5b")
    qwen, llama3 = get_arch("qwen3-0.6b"), get_arch("llama3-405b")
    gen = torch.Generator(device=dev).manual_seed(0)
    fm = random_fault_map(0, cfg.array_rows, cfg.array_cols, 0.1)
    ctx_k = from_fault_map(fm, "kernel", device=dev)
    ctx_f = from_fault_map(fm, "fap", device=dev)

    # ---- phase 2: kernel parity -------------------------------------------
    oks = {
        rate: from_fault_map(random_fault_map(0, 256, 256, rate), "kernel", device=dev).ok
        for rate in (0.0, 0.1, 0.3)
    }
    mm_err, mm_rows = 0.0, {}
    # the bf16 kernels read the mask as bits, packed once per mask tensor (and the 0/1 check);
    # the first packing in a process also loads the kernels of the ops it runs
    pack_ms = []
    for _ in range(2):
        fresh = oks[0.1].clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed_mask(fresh)
        torch.cuda.synchronize()
        pack_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"mask packing, once per FaultContext mask: {pack_ms[1]:.3f} ms (host clock, with its sync; "
        f"the process's first packing {pack_ms[0]:.3f} ms)")

    def gemm_case(arch, idx, k, n, uses, tied, dtype, ms_list):
        """Parity at three fault rates and timings at 10% for one weight shape
        at each M of ``ms_list``; returns the largest error.

        In bf16 the kernel the path picks (decode at M <= 16, mma above) runs
        on the bf16 copy of w and on the fp32 master read in place, as
        ``fault_linear`` hands it over in kernel mode; the two launches must
        give the same bits. v1 is timed beside them on the bf16 copy."""
        w32 = torch.randn(n, k, generator=gen, device=dev).T if tied else \
            torch.randn(k, n, generator=gen, device=dev)
        w32 = w32 / math.sqrt(k)
        w = w32.to(dtype)  # the plain path's cast; keeps embed.T's strides
        if tied and w.stride(0) != 1:
            raise Failed(f"the unembed weight lost its transposed strides: {w.stride()}")
        bf16 = dtype == torch.bfloat16
        shape_err = 0.0
        for m in ms_list:
            x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
            err = 0.0
            for rate, ok in oks.items():
                ref = masked_matmul_ref(x, w, ok)
                got = masked_matmul(x, w, ok)
                loads = masked_matmul.last_loads  # the mma kernel's load route of x and w: TMA or copies
                e, good = worst(got, ref, dtype_tol(dtype))
                err = max(err, e)
                if not good:
                    failures.append(f"masked_matmul {arch} {dtype} {m}x{k}x{n} rate {rate}: {e}")
                if bf16:
                    got32 = masked_matmul(x, w32, ok)
                    loads32 = masked_matmul.last_loads
                    e32, good32 = worst(got32, masked_matmul_ref(x, w32, ok), dtype_tol(dtype))
                    err = max(err, e32)
                    if not good32 or not torch.equal(got32, got):
                        failures.append(f"masked_matmul {arch} fp32 w {m}x{k}x{n} rate {rate}: err {e32}, "
                                        f"bit-identical to the bf16-w launch {torch.equal(got32, got)}")
            ok = oks[0.1]
            wm = w * (ok[torch.arange(k, device=dev) % 256][:, torch.arange(n, device=dev) % 256]).to(dtype)
            size = torch.finfo(dtype).bits // 8

            # the mask as every kernel reads it: its bits (packed along C, or along R for embed.T)
            r, c = ok.shape
            mask_bytes = c * -(-r // 8) if tied else r * -(-c // 8)

            def bound(w_size, prefix=""):
                """The bound and its two sides: each input read once, each output written once,
                at the HBM rate; the product's operations at the dtype's peak."""
                nbytes = (m * k + m * n) * size + k * n * w_size + mask_bytes
                sides = {f"{prefix}bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                         f"{prefix}ops_ms": 2 * m * k * n / PEAK_OPS[name_of(dtype)] * 1e3}
                return {f"{prefix}bound_ms": max(sides.values()), **sides}

            row = dict(
                variant=pick_variant(dtype, m),
                ms=time_ms(lambda: masked_matmul(x, w, ok)),
                plain_ms=time_ms(lambda: masked_matmul_ref(x, w, ok), reps=5),
                library_ms=time_ms(lambda: torch.matmul(x, wm)),
                **bound(size), uses=uses, k=k, n=n, tied=tied, max_abs_err=err, loads=loads,
            )
            if bf16:
                row.update(
                    f32w_loads=loads32,
                    f32w_ms=time_ms(lambda: masked_matmul(x, w32, ok)),
                    **bound(4, "f32w_"),
                    v1_ms=time_ms(lambda: masked_matmul(x, w, ok, variant="v1")),
                    cast_ms=time_ms(lambda: w32.to(dtype)),
                )
                row["cast_matmul_ms"] = row["cast_ms"] + row["library_ms"]
            mm_rows[(arch, name_of(dtype), m, idx)] = row
            log(f"masked_matmul {arch:15s} {name_of(dtype):8s} M={m:5d} K={k:5d} N={n:6d}"
                f"{' (embed.T)' if tied else ''}: err<= {err:.3g} (rtol, atol {dtype_tol(dtype)}) "
                f"{row['variant']}{' loads (x, w) ' + str(loads) if loads else ''} {row['ms']:.4f} ms"
                + (f"  fp32 w{' ' + str(loads32) if loads32 else ''} {row['f32w_ms']:.4f} ms (bound "
                   f"{row['f32w_bound_ms']:.4f})  v1 {row['v1_ms']:.4f} ms"
                   if bf16 else "")
                + f"  plain {row['plain_ms']:.4f} ms  torch.matmul(masked w) {row['library_ms']:.4f} ms  "
                f"bound {row['bound_ms']:.4f} ms"
                + (f"  cast fp32->bf16 {row['cast_ms']:.4f} ms" if bf16 else ""))
            shape_err = max(shape_err, err)
        return shape_err

    for dtype in (torch.bfloat16, torch.float32):
        for idx, (k, n, uses) in enumerate(cfg.gemm_shapes()):
            tied = n == cfg.vocab_size  # the unembed reads embed.T, a strided view
            # serving prefill gives the layers M = 4 x 128 and the long prefill
            # 4 x 2048; the unembed sees only the last position at prefill
            ms_list = (BATCH, 1024) if tied else (BATCH, BATCH * PROMPT, 1024, BATCH * LONG)
            mm_err = max(mm_err, gemm_case(cfg.name, idx, k, n, uses, tied, dtype, ms_list))

    fa_err, fa_rows = 0.0, {}
    b, d64 = BATCH, cfg.resolved_head_dim
    # (model, Hq, Hkv, S, case, window, Sq, D, causal): SmolLM's heads at the serving and
    # long-prefill lengths, hymba's (window 1024) at its long prefill; q_offset cases put Sq = S / 2
    # queries at the end of the keys; then the zoo's other head dims (FLASH_WIDE) at 4 x 2048
    flash_cells = [(cfg.name, cfg.num_heads, cfg.num_kv_heads, s, case, window, sq, d64, True)
                   for s in (128, LONG)
                   for case, window, sq in (("causal", None, s), ("window256", 256, s), ("q_offset", None, s // 2))]
    flash_cells += [(hymba.name, hymba.num_heads, hymba.num_kv_heads, LONG, case, hymba.sliding_window, sq, d64,
                     True) for case, sq in (("window1024", LONG), ("window1024_q_offset", LONG // 2))]
    flash_cells += [(model, hq, hkv, LONG, f"{'causal' if causal else 'encoder'}_d{d}", None, LONG, d, causal)
                    for model, hq, hkv, d, causal in FLASH_WIDE]
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        for model, hq, hkv, s, case, window, sq, d, causal in flash_cells:
            off = s - sq
            q = torch.randn(b, hq, sq, d, generator=gen, device=dev).to(dtype)
            kk = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(dtype)
            vv = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(dtype)
            kw = dict(causal=causal, window=window, q_offset=off)
            tol = FLASH_BF16_TOL if bf16 else dtype_tol(dtype)
            ref = attention_ref(q, kk, vv, **kw)
            err, good = worst(flash_attention(q, kk, vv, **kw), ref, tol)
            if bf16:  # v1 is held too: it stays reachable by its variant
                e1, good1 = worst(flash_attention(q, kk, vv, variant="v1", **kw), ref, tol)
                err, good = max(err, e1), good and good1
            fa_err = max(fa_err, err)
            if not good:
                failures.append(f"flash_attention {model} {dtype} S={s} {case}: {err}")
            rows = torch.arange(sq, device=dev)[:, None] + off
            cols = torch.arange(s, device=dev)[None, :]
            keep = cols <= rows if causal else torch.ones(sq, s, dtype=torch.bool, device=dev)
            if window:
                keep &= cols > rows - window
            pairs = int(keep.sum())
            size = torch.finfo(dtype).bits // 8
            nbytes = (2 * b * hq * sq * d + 2 * b * hkv * s * d) * size
            bound = max(nbytes / HBM_BYTES_PER_S, 4 * b * hq * d * pairs / PEAK_OPS[name_of(dtype)]) * 1e3
            kr, vr = kk.repeat_interleave(hq // hkv, 1), vv.repeat_interleave(hq // hkv, 1)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            row = dict(
                variant="mma" if bf16 else "v1",
                ms=time_ms(lambda: flash_attention(q, kk, vv, **kw)),
                plain_ms=time_ms(lambda: attention_ref(q, kk, vv, **kw), reps=3),
                library_ms=time_ms(lambda: sdpa(q, kr, vr, attn_mask=keep)),
                bound_ms=bound, max_abs_err=err, d=d,
            )
            if bf16:
                row["v1_ms"] = time_ms(lambda: flash_attention(q, kk, vv, variant="v1", **kw))
            fa_rows[(name_of(dtype), model, s, case)] = row
            log(f"flash_attention {model:11s} {name_of(dtype):8s} B={b} Hq={hq} Hkv={hkv} D={d} Sq={sq:5d} "
                f"Skv={s:5d} {case:19s}: err<= {err:.3g} (rtol, atol {tol}) {row['variant']} {row['ms']:.4f} ms"
                + (f"  v1 {row['v1_ms']:.4f} ms" if bf16 else "")
                + f"  plain {row['plain_ms']:.4f} ms  sdpa {row['library_ms']:.4f} ms  bound {bound:.4f} ms")
    del q, kk, vv, kr, vr, keep, ref

    # the selective scan, with inputs as the model gives them: dt fp32 from a
    # softplus, B and C strided slices of one (B, L, r + 2N) tensor in u's dtype
    scan_err, scan_rows = 0.0, {}
    for u_dtype in (torch.bfloat16, torch.float32):
        for bsz, length, dim, n in SCAN_SHAPES:
            u = torch.randn(bsz, length, dim, generator=gen, device=dev).to(u_dtype)
            dt = torch.nn.functional.softplus(torch.randn(bsz, length, dim, generator=gen, device=dev) - 3.0)
            a = -torch.exp(torch.randn(dim, n, generator=gen, device=dev))
            dbc = torch.randn(bsz, length, 8 + 2 * n, generator=gen, device=dev).to(u_dtype)
            _, bm, cm = torch.split(dbc, [8, n, n], dim=-1)
            d_skip = torch.randn(dim, generator=gen, device=dev)
            args_ = (u, dt, a, bm, cm, d_skip)
            y, h = selective_scan(*args_)
            plan = selective_scan.last_plan  # scan_plan's, on this card's SM count
            ref_y, ref_h = selective_scan_ref(*args_)
            y_tol = SCAN_F32_TOL if u_dtype == torch.float32 else \
                (2e-2, 1e-2 * float(ref_y.float().pow(2).mean().sqrt()))
            y_err, y_good = worst(y, ref_y, y_tol)
            h_err, h_good = worst(h, ref_h, SCAN_F32_TOL)
            scan_err = max(scan_err, y_err, h_err)
            key = f"{name_of(u_dtype)} {bsz}x{length}x{dim}x{n}"
            if not (y_good and h_good):
                failures.append(f"selective_scan {key}: y err {y_err} (tol {y_tol}), h err {h_err}")
            size = torch.finfo(u_dtype).bits // 8
            elems = bsz * length * dim * n
            nbytes = (bsz * length * dim * (2 * size + 4) + 2 * bsz * length * n * size
                      + dim * n * 4 + dim * 4 + bsz * dim * n * 4)
            # the bound: bytes at the HBM rate, 7 fp32 operations per (b, t, d, n) at the fp32 rate,
            # or one exponential per (b, t, d, n) on the SFUs, whichever takes longest
            sides = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": 7 * elems / PEAK_OPS["float32"] * 1e3,
                     "exps": elems / SFU_PER_S * 1e3}
            by = max(sides, key=sides.get)
            row = dict(
                ms=time_ms(lambda: selective_scan(*args_)),
                plain_ms=time_ms(lambda: selective_scan_ref(*args_), reps=3),
                bound_ms=sides[by], bound_by=by, bytes_ms=sides["bytes"], ops_ms=sides["operations"],
                exp_ms=sides["exps"], y_err=y_err, y_tol=y_tol, h_err=h_err, mbytes=nbytes / 1e6,
                plan=plan._asdict(),
            )
            scan_rows[key] = row
            log(f"selective_scan {key:24s}: y err {y_err:.3g} (rtol, atol {y_tol[0]}, {y_tol[1]:.3g}), "
                f"h_last err {h_err:.3g} (rtol, atol {SCAN_F32_TOL}); plan {plan.lanes} lanes x {plan.states} "
                f"states a channel, {plan.blocks} blocks; kernel {row['ms']:.4f} ms  "
                f"plain {row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms ({by}; bytes "
                f"{row['mbytes']:.1f} MB {sides['bytes']:.4f} ms, 7 fp32 ops/elem {sides['operations']:.4f} ms, "
                f"exps on the SFUs {sides['exps']:.4f} ms)")
    del u, dt, a, dbc, bm, cm, args_, y, h, ref_y, ref_h

    # the masked GEMM at the SSM models' shapes, bf16 and float32, as their serving paths run it
    for dtype in (torch.bfloat16, torch.float32):
        for arch in (falcon, hymba):
            for idx, (k, n, uses) in enumerate(arch.gemm_shapes()):
                unembed = n == arch.vocab_size
                ms_list = (BATCH, BATCH * PROMPT) + (() if unembed or arch is falcon else (BATCH * LONG,))
                mm_err = max(mm_err, gemm_case(arch.name, idx, k, n, uses, False, dtype, ms_list))
    # llama3-405b's GEMMs, the zoo's widest (its unembed's 16384 x 128256 weight is 97.9% of INT_MAX
    # elements), at a decode step's M and a serving prefill's; no llama3 model fits the card
    for dtype in (torch.bfloat16, torch.float32):
        seen = set()
        for idx, (k, n, uses) in enumerate(llama3.gemm_shapes()):
            if (k, n) not in seen:  # wq and wo share a shape
                seen.add((k, n))
                mm_err = max(mm_err, gemm_case(llama3.name, idx, k, n, uses, False, dtype, (BATCH, BATCH * PROMPT)))
    if failures:
        raise Failed("kernel parity: " + "; ".join(failures))
    torch.cuda.empty_cache()

    # ---- phase 3: int8 decode attention (dense) against its plain version ---
    def sdpa_gqa(q, k, v, mask=None):
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

    def decode_bound(nbytes, flops):
        """(bound ms, bound_by): bytes at the HBM rate against the kernels'
        fp32 FMAs at the fp32 rate."""
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_OPS["float32"] * 1e3
        return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"

    def int8_cache(b, hkv, skv, d):
        ki, ks = da.quantize_kv(torch.randn(b, hkv, skv, d, generator=gen, device=dev))
        vi, vs = da.quantize_kv(torch.randn(b, hkv, skv, d, generator=gen, device=dev))
        return ki, ks, vi, vs

    def split_grid(b, hq, hkv, splits):
        """Blocks of a split-KV launch: (sequence, KV head, head chunk) x splits."""
        return b * hkv * da.head_chunks(hq // hkv) * splits

    prev_cache = set_tuning_cache(TuningCache(source="<chip_smoke: heuristic>"))
    sms = da.sm_count(dev)
    da_err, da_rows, da_inputs = 0.0, {}, {}
    for label, (b, hq, hkv, skv, d), valids in DECODE_CELLS:
        cache = int8_cache(b, hkv, skv, d)
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(b, hq, 1, d, generator=gen, device=dev).to(dtype)
            da_inputs[(label, name_of(dtype))] = (q, cache)
            tol = DECODE_TOL[name_of(dtype)]
            for valid in valids:
                got = da.decode_attention(q, *cache, valid)
                splits = da.decode_attention.last_splits
                err, good = worst(got, da.decode_attention_ref(q, *cache, kv_valid_len=valid), tol)
                da_err = max(da_err, err)
                if not good or (valid == 0 and bool(got.abs().any())):
                    failures.append(f"decode_attention {label} {dtype} valid {valid}: {err}")
                # the merge runs in split order and the plan reads no device value: same bits
                dev_len = torch.tensor([valid], dtype=torch.int32, device=dev)
                if not (torch.equal(da.decode_attention(q, *cache, valid), got)
                        and torch.equal(da.decode_attention(q, *cache, dev_len), got)):
                    failures.append(f"decode_attention {label} {dtype} valid {valid}: two launches, or an "
                                    "int and a device length, gave different bits")
                tiles = -(-skv // da.decode_attention.last_bkv)
                if tiles > 1 and b * hkv < 2 * sms and split_grid(b, hq, hkv, splits) <= b * hkv:
                    failures.append(f"decode_attention {label}: {splits} splits launch no more blocks than "
                                    f"{b * hkv} (sequence, KV head)s")
                if valid == 0:
                    log(f"decode_attention {label:10s} {name_of(dtype):8s} valid 0: output all zero "
                        f"{not bool(got.abs().any())}, err<= {err:.3g}")
                    continue
                kd, vd = (da.dequantize_kv(i, sc, dtype)[:, :, :valid] for i, sc in (cache[:2], cache[2:]))
                # the valid prefix of int8 K and V with their fp32 scales, q read and o written in q's dtype
                nbytes = 2 * b * hkv * valid * (d + 4) + 2 * b * hq * d * q.element_size()
                bound, bound_by = decode_bound(nbytes, 4.0 * b * hq * valid * d)
                row = dict(
                    ms=time_ms(lambda: da.decode_attention(q, *cache, valid)),
                    plain_ms=time_ms(lambda: da.decode_attention_ref(q, *cache, kv_valid_len=valid), reps=3),
                    library_ms=time_ms(lambda: sdpa_gqa(q, kd, vd)),
                    bound_ms=bound, bound_by=bound_by, mbytes=nbytes / 1e6, max_abs_err=err,
                    bkv=da.decode_attention.last_bkv, splits=splits, blocks=split_grid(b, hq, hkv, splits),
                )
                # the split rule on the card: the plan's count against 1 and one split per tile
                for forced in sorted({1, tiles} - {splits}):
                    again = da.decode_attention(q, *cache, valid, splits=forced)
                    f_err, f_good = worst(again, da.decode_attention_ref(q, *cache, kv_valid_len=valid), tol)
                    da_err = max(da_err, f_err)
                    if not f_good:
                        failures.append(f"decode_attention {label} {dtype} valid {valid} splits {forced}: {f_err}")
                    row[f"ms_splits_{forced}"] = time_ms(
                        lambda: da.decode_attention(q, *cache, valid, splits=forced))
                da_rows[(label, name_of(dtype), valid)] = row
                forced_txt = ", ".join(f"{k[10:]} splits {v:.4f} ms" for k, v in row.items()
                                       if k.startswith("ms_splits_"))
                log(f"decode_attention {label:10s} {name_of(dtype):8s} B={b} Hq={hq} Hkv={hkv} S={skv} "
                    f"D={d} valid {valid:4d} bkv {row['bkv']}, {splits} splits, {row['blocks']} blocks: "
                    f"err<= {err:.3g} (rtol, atol {tol}) "
                    f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  library yardstick (SDPA "
                    f"on K/V dequantized to {name_of(dtype)}, not a port) {row['library_ms']:.4f} ms  "
                    f"bound {bound:.5f} ms ({bound_by}, {row['mbytes']:.3f} MB); forced: {forced_txt}")

    # every tile the lint accepts launches and agrees, in float32 at the table's tolerance (where a
    # key dropped or counted twice per tile shows) and in bf16; the rejected ones are never launched
    lattice_report = {}
    for label, (b, hq, hkv, skv, d), valids in DECODE_CELLS:
        for dname in ("float32", "bfloat16"):
            q, cache = da_inputs[(label, dname)]
            ref = da.decode_attention_ref(q, *cache, kv_valid_len=valids[0])
            accepted, rejected, lat_err, lat_splits = [], {}, 0.0, {}
            for bkv in pow2_lattice(skv, lo=8):
                findings, smem = lint_candidate("decode_attention", dict(b=b, hq=hq, hkv=hkv, skv=skv, d=d),
                                                q.dtype, dict(bkv=bkv))
                if findings:
                    rejected[bkv] = [f.code for f in findings]
                    continue
                got = da.decode_attention(q, *cache, valids[0], bkv=bkv)
                torch.cuda.synchronize()
                err, good = worst(got, ref, DECODE_TOL[dname])
                da_err, lat_err = max(da_err, err), max(lat_err, err)
                if not good:
                    failures.append(f"decode_attention {label} {dname} bkv {bkv} ({smem} B of shared "
                                    f"memory): {err}")
                accepted.append(bkv)
                lat_splits[bkv] = da.decode_attention.last_splits
            lattice_report[(label, dname)] = dict(accepted=accepted, rejected=rejected, max_abs_err=lat_err,
                                                  splits=lat_splits)
            log(f"decode_attention {label:10s} {dname:8s} lattice: launched and agreed at bkv {accepted} "
                f"(err<= {lat_err:.3g}, rtol, atol {DECODE_TOL[dname]}), splits by bkv {lat_splits}; "
                f"lint-rejected {rejected}")
    if failures:
        raise Failed("decode attention parity: " + "; ".join(failures))

    # ---- phase 4: paged decode attention over a PageAllocator pool ---------
    # SmolLM-135M's heads (the main path of kernel #4), then phi3-mini's head dim 96 over the same kind of pool
    pg_rows = {}
    for pg_label, (hq, hkv, d) in (("smollm", (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)),
                                   ("phi3", (32, 32, 96))):
        b, page = PAGED_SLOTS, 8
        lens = torch.randint(1, LONG + 1, (b,), generator=gen, device=dev)
        lens[0], lens[1], lens[2] = 0, 1001, LONG  # empty, ending mid-page, a full chain
        lens_host = lens.tolist()
        chains = [pages_needed(n, page) for n in lens_host]
        alloc = PageAllocator(1 + sum(chains) + 64, page)
        owned = [alloc.alloc(n) if n else [] for n in chains]
        for slot in range(0, b, 2):  # free every other chain and allocate them again, newest first
            if owned[slot]:
                alloc.free(owned[slot])
        for slot in reversed(range(0, b, 2)):
            owned[slot] = alloc.alloc(chains[slot]) if chains[slot] else []
        maxp = max(chains)
        pool = [torch.zeros(hkv, alloc.num_pages, page, d, dtype=torch.int8, device=dev),
                torch.zeros(hkv, alloc.num_pages, page, device=dev)]
        pool = pool + [t.clone() for t in pool]  # k, k scales, v, v scales
        # stale table entries past each chain: pages other chains own, as a freed slot leaves them
        stale = torch.randint(1, alloc.num_pages, (b, maxp), generator=gen, device=dev, dtype=torch.int32)
        tables = stale.clone()
        for slot, ids in enumerate(owned):
            if not ids:
                continue
            tables[slot, :len(ids)] = torch.tensor(ids, dtype=torch.int32, device=dev)
            ids_t = torch.tensor(ids, device=dev)
            for which in (0, 2):
                ki, ks = da.quantize_kv(torch.randn(1, 1, hkv, lens_host[slot], d, generator=gen, device=dev))
                pool[which][:, ids_t] = chain_layout(ki, page, len(ids))[0].movedim(0, 1)
                pool[which + 1][:, ids_t] = chain_layout(ks[..., None], page, len(ids))[0, ..., 0].movedim(0, 1)
        lens32 = lens.to(torch.int32)
        past_chain = torch.arange(maxp, device=dev)[None] >= torch.tensor(chains, device=dev)[:, None]
        log(f"paged pool: {alloc.num_pages} pages of {page} tokens, {alloc.pages_in_use} in use "
            f"(high water {alloc.high_water}); {b} slots, lengths {min(lens_host)}..{max(lens_host)}, "
            f"maxp {maxp}; first chain ids {owned[2][:6]}")

        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(b, hq, 1, d, generator=gen, device=dev).to(dtype)
            args_ = (q, *pool, tables, lens32)
            da.paged_decode_attention.launches = 0  # the main path of kernel #4: one decode read
            got = da.paged_decode_attention(*args_)
            torch.cuda.synchronize()
            pg_launches = da.paged_decode_attention.launches
            pg_splits = da.paged_decode_attention.last_splits
            if pg_launches != 1:
                raise Failed(f"paged_decode_attention: {pg_launches} launches for one call")
            pg_tiles = -(-maxp * page // da.paged_tile(page))
            if pg_tiles > 1 and b * hkv < 2 * sms and split_grid(b, hq, hkv, pg_splits) <= b * hkv:
                raise Failed(f"paged_decode_attention: {pg_splits} splits launch no more blocks than {b * hkv}")
            tol = DECODE_TOL[name_of(dtype)]
            err, good = worst(got, da.paged_decode_attention_ref(*args_), tol)
            # page ids past a chain are never read: out-of-pool ids there change nothing
            wild = torch.where(past_chain, torch.full_like(tables, 2**30), tables)
            untouched = torch.equal(da.paged_decode_attention(q, *pool, wild, lens32), got)
            if not good or not untouched or bool(got[0].abs().any()):
                raise Failed(f"paged_decode_attention {dtype}: err {err} (tol {tol}), stale ids never read "
                             f"{untouched}, empty slot zero {not bool(got[0].abs().any())}")
            for forced in sorted({1, pg_tiles} - {pg_splits}):  # the splits forced to 1 and one per tile
                f_err, f_good = worst(da.paged_decode_attention(*args_, splits=forced),
                                      da.paged_decode_attention_ref(*args_), tol)
                if not f_good:
                    raise Failed(f"paged_decode_attention {dtype} splits {forced}: err {f_err} (tol {tol})")
                err = max(err, f_err)
            dense_k, dense_v = (da.gather_pages(da.dequantize_kv(pool[i], pool[i + 1], dtype), tables)
                                for i in (0, 2))
            mask = (torch.arange(maxp * page, device=dev)[None] < lens[:, None])[:, None, None, :]
            tokens = sum(lens_host)
            nbytes = (2 * hkv * tokens * (d + 4) + 2 * b * hq * d * q.element_size()
                      + 4 * sum(chains) + 4 * b)
            bound, bound_by = decode_bound(nbytes, 4.0 * hq * tokens * d)
            row = pg_rows[f"{pg_label} {name_of(dtype)}"] = dict(
                ms=time_ms(lambda: da.paged_decode_attention(*args_)),
                plain_ms=time_ms(lambda: da.paged_decode_attention_ref(*args_), reps=3),
                library_ms=time_ms(lambda: sdpa_gqa(q, dense_k, dense_v, mask)),
                bound_ms=bound, bound_by=bound_by, mbytes=nbytes / 1e6, max_abs_err=err,
                launches=pg_launches, tokens=tokens, splits=pg_splits, blocks=split_grid(b, hq, hkv, pg_splits),
            )
            log(f"paged_decode_attention {pg_label} {name_of(dtype):8s} {b} slots x Hq={hq} Hkv={hkv} D={d}, "
                f"{tokens} tokens in {sum(chains)} pages, {pg_splits} splits of {pg_tiles} {da.paged_tile(page)}-token "
                f"tiles, {row['blocks']} blocks: err<= {err:.3g} (rtol, atol {tol}; the forced splits too); "
                f"stale ids never "
                f"read; kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  library yardstick (SDPA on "
                f"the gathered cache dequantized to {name_of(dtype)}, not a port) {row['library_ms']:.4f} ms  "
                f"bound {bound:.5f} ms ({bound_by}, {row['mbytes']:.3f} MB)")
        del pool, dense_k, dense_v, mask

    # ---- phase 5: the kernel autotuner over the dense cells ----------------
    rec = Recorder()
    da.decode_attention.launches = 0  # the main path of kernel #3: the tuner
    t0 = time.perf_counter()
    tune_results, table = tune_many(
        [("decode_attention", dict(b=b_, hq=hq_, hkv=hkv_, skv=s_, d=d_))
         for label, (b_, hq_, hkv_, s_, d_), _ in DECODE_CELLS if label != "tune-suite"],
        dtype=torch.bfloat16, device=dev, recorder=rec)
    b_, hq_, hkv_, s_, d_ = DECODE_CELLS[0][1]  # the reference's tune suite runs it in float32
    more, table = tune_many([("decode_attention", dict(b=b_, hq=hq_, hkv=hkv_, skv=s_, d=d_))],
                            cache=table, dtype=torch.float32, device=dev, recorder=rec)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    tune_results += more
    tune_launches = da.decode_attention.launches
    spans = sum(1 for e in rec.event_list() if e.kind == "span")
    if not tune_launches or spans != sum(r.evaluated for r in tune_results):
        raise Failed(f"tuner: {tune_launches} launches, {spans} spans")
    tune_report = []
    for r in tune_results:
        grids = {k: decode_attention_launch(*(r.shape[f] for f in ("b", "hq", "hkv", "skv", "d")),
                                            bkv=blk["bkv"], sm_count=sms).grid
                 for k, blk in (("heuristic", r.heuristic_blocks), ("tuned", r.best_blocks))}
        tune_report.append(dict(key=r.key, heuristic=r.heuristic_blocks, heuristic_us=r.heuristic_s * 1e6,
                                tuned=r.best_blocks, tuned_us=r.best_s * 1e6, speedup=r.speedup,
                                roofline_fraction=r.roofline_fraction, smem_bytes=r.smem_bytes,
                                evaluated=r.evaluated, rejected=r.rejected_configs,
                                heuristic_splits=grids["heuristic"][1], tuned_splits=grids["tuned"][1],
                                tuned_blocks=grids["tuned"][0] * grids["tuned"][1]))
        log(f"tune {r.key}: heuristic bkv {r.heuristic_blocks['bkv']} ({grids['heuristic'][1]} splits) "
            f"{r.heuristic_s * 1e6:.2f} us, tuned bkv {r.best_blocks['bkv']} ({grids['tuned'][1]} splits, "
            f"{grids['tuned'][0] * grids['tuned'][1]} blocks) {r.best_s * 1e6:.2f} us (x{r.speedup:.3f}; "
            f"H100 roofline fraction "
            f"{r.roofline_fraction:.4f}; {r.smem_bytes} B shared memory); evaluated {r.evaluated}, "
            f"rejected {r.rejected} {[(x['blocks']['bkv'], x['codes']) for x in r.rejected_configs]}")
    log(f"tuner: {len(tune_results)} cells in {tune_s:.2f} s, {tune_launches} kernel launches, {spans} "
        f"recorder spans, {rec.metrics.counter('tune.lint_rejected').value} lint rejections; the recorder's own "
        f"host time {rec.self_time_s * 1e3:.3f} ms")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    table.save(str(OUT_DIR / "tune_decode_attention.json"))

    # the tuned table as the process cache: a call with no bkv launches the tuned tile
    set_tuning_cache(table)
    for label, (b_, hq_, hkv_, s_, d_), valids in DECODE_CELLS:
        dname = "float32" if label == "tune-suite" else "bfloat16"
        q, cache = da_inputs[(label, dname)]
        want = table.lookup_blocks("decode_attention", dict(b=b_, hq=hq_, hkv=hkv_, skv=s_, d=d_),
                                   dname, "cuda")["bkv"]
        got = da.decode_attention(q, *cache, valids[0])
        err, good = worst(got, da.decode_attention_ref(q, *cache, kv_valid_len=valids[0]), DECODE_TOL[dname])
        if da.decode_attention.last_bkv != want or not good:
            raise Failed(f"tuned {label}: launched bkv {da.decode_attention.last_bkv}, table {want}, err {err}")
        row = da_rows.get((label, dname, valids[0]))
        if row is not None:
            row["tuned_bkv"], row["tuned_ms"] = want, time_ms(lambda: da.decode_attention(q, *cache, valids[0]))
            row["tuned_splits"] = da.decode_attention.last_splits
        log(f"tuned table in use, {label} {dname}: launched bkv {want} ({da.decode_attention.last_splits} "
            f"splits), err<= {err:.3g}"
            + (f"; kernel {row['tuned_ms']:.4f} ms (heuristic {row['ms']:.4f} ms)" if row else ""))
    del da_inputs
    torch.cuda.empty_cache()

    # the other three kernels' spaces, from an empty cache: tune, then install the table and check
    # that each wrapper called with no blocks launches the tuned ones and matches its plain version
    space = tune_spaces(torch, log, table, rec, dev)
    tune_report += space["rows"]
    space_launches, space_err = space["launches"], space["max_abs_err"]
    set_tuning_cache(prev_cache)
    torch.cuda.empty_cache()

    # the geometry lint over every registered configuration's launches, at the heuristics
    lint_stats = {}
    for arch in list_archs(include_paper=True):
        findings, stats = lint_kernels(kernel_launches(get_arch(arch)))
        if findings:
            raise Failed(f"kernel geometry lint, {arch}: {[(f.code, f.entry_point, f.message) for f in findings]}")
        lint_stats[arch] = stats
    log(f"kernel geometry lint: {len(lint_stats)} configurations x {len(next(iter(lint_stats.values())))} "
        "launches, no findings")

    # the analyses' cheap passes (recompile, sharding, kernels) over the archs the stack lints,
    # against the committed baseline; the CPU donation run the card's entry points are held to
    t0 = time.perf_counter()
    baseline = load_baseline(default_baseline_path())
    analysis_report = dict(keys={})
    for arch in ANALYSIS_ARCHS:
        rep = analyze_stack(arch, passes=("recompile", "sharding", "kernels"))
        new = rep.new_vs_baseline(baseline)
        if new:
            raise Failed(f"analyze_stack {arch}: keys outside the baseline {[f.key for f in new]}")
        analysis_report["keys"][arch] = sorted(rep.keys())
    for arch in ANALYSIS_REFUSED:
        try:
            analyze_stack(arch, passes=("recompile", "sharding", "kernels"))
            raise Failed(f"analyze_stack {arch}: not refused")
        except ValueError:
            pass
    analysis_report["cheap_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_donation_subjects(log)
    analysis_report["cpu_donation_seconds"] = time.perf_counter() - t0
    log(f"analyses: cheap passes over {len(ANALYSIS_ARCHS)} archs in {analysis_report['cheap_seconds']:.2f} s, "
        f"no key outside the baseline ({ {a: len(k) for a, k in analysis_report['keys'].items()} } keys), "
        f"{len(ANALYSIS_REFUSED)} refused; the CPU donation run (reduced SmolLM-135M) "
        f"{analysis_report['cpu_donation_seconds']:.2f} s")

    # ---- serving: shared by phases 6-10 and 15 -----------------------------
    reset = reset_launches

    def counts():
        return dict(masked_matmul=masked_matmul.launches, flash_attention=flash_attention.launches,
                    selective_scan=selective_scan.launches)

    def check_variants(label, dtype_name, got):
        """bf16 runs launch only the bf16 kernels, float32 runs only v1."""
        wrong = {k: n for k, n in got.items() if n and (k.endswith(".v1") == (dtype_name == "bfloat16"))}
        if wrong:
            raise Failed(f"{label}: {dtype_name} launched the wrong kernels {wrong}")

    launches = {"masked_matmul": 0, "flash_attention": 0, "selective_scan": 0}
    variant_launches = dict.fromkeys(variant_counts(), 0)
    # the main path's mma launches that copied an operand TMA refuses, and its decode launches whose w
    # runs start off 16 bytes (bulk copies from the boundary below, read at an offset)
    copied = dict(mma=0, decode=0)

    serve_report, profile_report, profile_lines = {}, {}, []

    def serve(c, params, atol_scale, elementwise=True, analyses=False):
        """Serve 4 x 128-token prompts, 32 greedy new tokens, in kernel mode;
        gate the launch counts and the teacher-forced logits and logprobs.

        The served sequence is re-run teacher-forced through the plain
        ``fap`` path (``ref``) and the kernel path (``got``). With
        ``elementwise`` the logits of the two and the served logprobs are
        held elementwise to ``dtype_tol``. A bf16 run is also held against
        the plain path in float32 (``ref32``): the kernel path's relative L2
        error on the logits, and the served logprobs' RMS error, may be at
        most ANCHOR_RATIO times the plain bf16 path's own. With ``analyses``
        (phase 6's bf16 serve) the engine's sample-decode passes the
        donation gate on the prefill's cache, and the dry run of the decode
        cell at the engine's batch and capacity gives the live params' and
        cache's bytes."""
        label = f"{c.name} {c.dtype}"
        prompts = torch.randint(0, c.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
        per_step = sum(uses for _, _, uses in c.gemm_shapes())
        eng = ServeEngine(c, params, ctx_k, max_len=None)
        eng.generate(prompts, max_new_tokens=2)  # warm-up, not counted
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new_tokens=NEW)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got_counts, got_variants = counts(), variant_counts()
        for key in launches:
            launches[key] += got_counts[key]
        for key in variant_launches:
            variant_launches[key] += got_variants[key]
        copied["mma"] += masked_matmul.copy_launches
        copied["decode"] += masked_matmul.offset_launches
        want = dict(masked_matmul=per_step * (1 + NEW), flash_attention=0,
                    selective_scan=c.num_layers if c.has_ssm else 0)
        if got_counts != want:
            raise Failed(f"serve {label}: launches {got_counts}, expected {want} "
                         f"({per_step} masked GEMMs per step x {1 + NEW} steps)")
        check_variants(f"serve {label}", c.dtype, got_variants)
        casts = None
        if c.dtype == "bfloat16":  # kernel mode reads the fp32 master in place: no weight is cast
            shapes = {sh for k_, n_, _ in c.gemm_shapes() for sh in ((k_, n_), (n_, k_))}
            with weight_cast_watch(torch, shapes) as watch:
                eng.generate(prompts, max_new_tokens=2)
                torch.cuda.synchronize()
            casts = len(watch.seen)
            if casts:
                raise Failed(f"serve {label}: kernel mode cast GEMM weights to bf16: {watch.seen[:8]}")
        if not torch.isfinite(out.logprobs).all() or out.tokens.shape != (BATCH, PROMPT + NEW):
            raise Failed(f"serve {label}: bad output {tuple(out.tokens.shape)}")
        t1 = time.perf_counter()
        kw = {} if c.has_ssm else dict(valid_len=PROMPT)  # SSM families prefill unpadded
        cache_len = eng.cache_len_for(PROMPT, NEW)
        live_logits, live_cache = M.prefill(params, {"tokens": prompts}, c, ctx_k, cache_len=cache_len, **kw)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3

        seq, steps = out.tokens, slice(PROMPT - 1, PROMPT - 1 + NEW)

        def teacher_forced(cc, ctx):
            with torch.no_grad():
                logits = M.forward(params, {"tokens": seq[:, :-1]}, cc, ctx, attn_impl="dense")[0][:, steps].float()
            return logits, torch.log_softmax(logits, -1).gather(-1, seq[:, PROMPT:, None])[..., 0]

        ref, ref_lp = teacher_forced(c, ctx_f)
        got, _ = teacher_forced(c, ctx_k)
        rtol, atol = dtype_tol(getattr(torch, c.dtype), atol_scale=atol_scale)
        lp_err = float((out.logprobs - ref_lp).abs().max())
        logit_diff = (got - ref).abs()
        logit_err = float(logit_diff.max())
        agree = float((ref.argmax(-1) == seq[:, PROMPT:]).float().mean())
        report = serve_report[label] = dict(
            tokens_per_s=BATCH * NEW / dt, generate_s=dt, step_ms=dt / (1 + NEW) * 1e3,
            prefill_ms=prefill_ms, launches=got_counts, variant_launches=got_variants, weight_casts=casts,
            launches_per_step=got_counts["masked_matmul"] / (1 + NEW),
            logprob_err=lp_err, logit_err=logit_err, ref_logit_rms=float(ref.pow(2).mean().sqrt()),
            token_agreement=agree, elementwise_gate=elementwise,
        )
        log(f"serve {label}: {BATCH}x{NEW} tokens in {dt:.3f} s ({BATCH * NEW / dt:.1f} tok/s); "
            f"prefill {BATCH}x{PROMPT} {prefill_ms:.2f} ms; launches {got_counts} "
            f"({got_counts['masked_matmul'] / (1 + NEW):.0f} masked GEMMs per step; by kernel "
            f"{ {k: n for k, n in got_variants.items() if n} }; fp32->bf16 weight casts in kernel mode "
            f"{'not checked' if casts is None else casts}); teacher-forced fap: "
            f"logprob err {lp_err:.3g}, logit err {logit_err:.3g} (rtol {rtol}, atol {atol}"
            f"{'' if elementwise else '; not gated, see the anchored gate'}), greedy token agreement {agree:.4f}")
        if elementwise and (
            lp_err > atol or not bool((logit_diff <= atol + rtol * ref.abs()).all())
        ):
            raise Failed(f"serve {label}: served logits disagree with the plain fap path")
        if c.dtype == "bfloat16":
            ref32, ref32_lp = teacher_forced(dataclasses.replace(c, dtype="float32"), ctx_f)
            anchored = dict(
                plain_rel_l2=rel_l2(ref, ref32), kernel_rel_l2=rel_l2(got, ref32),
                plain_max=float((ref - ref32).abs().max()), kernel_max=float((got - ref32).abs().max()),
                plain_lp_rms=float((ref_lp - ref32_lp).pow(2).mean().sqrt()),
                served_lp_rms=float((out.logprobs - ref32_lp).pow(2).mean().sqrt()),
            )
            report["anchored"] = anchored
            ratios = (anchored["kernel_rel_l2"] / anchored["plain_rel_l2"],
                      anchored["served_lp_rms"] / anchored["plain_lp_rms"])
            log(f"serve {label} against the plain path in float32: logits rel L2 plain bf16 "
                f"{anchored['plain_rel_l2']:.4g}, kernel bf16 {anchored['kernel_rel_l2']:.4g} (ratio "
                f"{ratios[0]:.3f} <= {ANCHOR_RATIO}); max err plain {anchored['plain_max']:.3g}, kernel "
                f"{anchored['kernel_max']:.3g}; logprob RMS err plain teacher-forced "
                f"{anchored['plain_lp_rms']:.4g}, served {anchored['served_lp_rms']:.4g} (ratio "
                f"{ratios[1]:.3f} <= {ANCHOR_RATIO})")
            if max(ratios) > ANCHOR_RATIO:
                raise Failed(f"serve {label}: the kernel path is farther from the float32 plain path "
                             f"than the bf16 plain path is: {anchored}")
            if args.profile:
                profile(label, eng, prompts)
        if analyses:
            per_step = sum(uses for _, _, uses in c.gemm_shapes())
            report["donation"] = donation_gate(torch, log, "phase 6", [
                sample_decode_spec(eng, live_logits, live_cache)], {"serve.sample_decode": per_step})
            report["dryrun"] = dryrun_gate(c, params, live_cache, cache_len)
        return eng

    def dryrun_gate(c, params, cache, cache_len):
        """The dry run's decode cell at the engine's batch and capacity on a
        1 x 1 mesh: its per-device bytes must be the live engine's params'
        and cache's, exactly (the cache's int index counted as the int32
        scalar the dry run, like the reference, holds)."""
        from repro_torch.configs import ShapeConfig
        from repro_torch.launch.dryrun_lib import build_cell
        from repro_torch.launch.mesh import make_host_mesh

        t0 = time.perf_counter()
        cell = ShapeConfig(f"decode_{cache_len}", cache_len, BATCH, "decode")
        _, info = build_cell(c.name, cell, mesh=make_host_mesh(1, 1, devices=["meta"]), cfg=c)
        live = dict(param_bytes_per_device=sum(p.numel() * p.element_size() for p in params.parameters()),
                    cache_bytes_per_device=sum(t.numel() * t.element_size() for t in cache.values()
                                               if torch.is_tensor(t)) + 4)
        got = {k: info[k] for k in live}
        seconds = time.perf_counter() - t0
        log(f"dry run {c.name} decode cell {BATCH}x{cache_len} on a 1x1 mesh: {got} against the live engine's "
            f"{live}; {seconds:.2f} s")
        if got != live:
            raise Failed(f"dry run {c.name}: per-device bytes {got}, the live engine holds {live}")
        return dict(dryrun=got, live=live, seconds=seconds)

    def profile(label, eng, prompts, prof_new=8):
        """Where one bf16 serving run's device time goes."""
        from torch.profiler import ProfilerActivity, profile as torch_profile

        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=prof_new)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.generate(prompts, max_new_tokens=prof_new)
            torch.cuda.synchronize()
        by_kernel = sorted(
            ((e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
             if e.self_device_time_total > 0),
            key=lambda r: -r[2],
        )
        busy_ms = sum(t for _, _, t in by_kernel)
        if not busy_ms:
            raise Failed("profile: torch.profiler recorded no device time")
        profile_report[label] = dict(new_tokens=prof_new, wall_ms=wall_ms, busy_ms=busy_ms,
                                     busy_share=busy_ms / wall_ms)
        lines = [
            f"{label}: card {card}; kernel mode; {BATCH}x{PROMPT} prompt, {prof_new} new tokens",
            f"untraced wall {wall_ms:.2f} ms; traced device time {busy_ms:.2f} ms "
            f"(busy {busy_ms / wall_ms:.1%} of the untraced wall)",
            f"{'device ms':>10} {'share':>7} {'calls':>7}  kernel",
        ] + [f"{t:10.3f} {t / busy_ms:7.1%} {n:7d}  {key[:110]}" for key, n, t in by_kernel[:25]]
        profile_lines.extend(lines + [""])
        for line in lines[:12]:
            log(f"profile: {line}")

    def long_prefill(c, params, anchored):
        """``prefill`` at 4 x 2048 in bf16 through the kernels against the plain
        path: fap masking, dense attention and the scan's plain version (swapped
        in for the plain runs).

        Without ``anchored`` the logits and KV cache of the two are held
        elementwise to ``dtype_tol`` and by relative L2 (at most MAX_REL_L2).
        With it, both paths run in float32 too: there the kernel path is held
        elementwise to the plain path (``dtype_tol``, atol_scale 50) and by
        relative L2; and in bf16 each path's relative L2 error against the plain
        float32 path is compared, the kernel path's being at most ANCHOR_RATIO
        times the plain path's own."""
        per_step = sum(uses for _, _, uses in c.gemm_shapes())
        tokens = {"tokens": torch.randint(0, c.vocab_size, (BATCH, LONG), generator=gen, device=dev)}
        # a warm-up at the timed shape, not counted: the timed run meets no kernel instance (the mma
        # kernel's 256-token tile, which a shorter warm-up leaves unused) at its first launch
        M.prefill(params, tokens, c, ctx_k, attn_impl="kernel")
        torch.cuda.synchronize()
        want = dict(masked_matmul=per_step, flash_attention=c.num_layers,
                    selective_scan=c.num_layers if c.has_ssm else 0)

        def kernel_run(cc):
            """One main-path prefill through the kernels, its launches counted."""
            reset()
            t0 = time.perf_counter()
            out = M.prefill(params, tokens, cc, ctx_k, attn_impl="kernel")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got_counts, got_variants = counts(), variant_counts()
            for key in launches:
                launches[key] += got_counts[key]
            for key in variant_launches:
                variant_launches[key] += got_variants[key]
            copied["mma"] += masked_matmul.copy_launches
            copied["decode"] += masked_matmul.offset_launches
            if got_counts != want:
                raise Failed(f"long prefill {c.name} {cc.dtype}: launches {got_counts}, expected {want}")
            check_variants(f"long prefill {c.name}", cc.dtype, got_variants)
            return out, ms, got_counts, got_variants

        kernel_out, kernel_ms, got_counts, got_variants = kernel_run(c)
        outs = {"kernel": kernel_out}

        def plain(cc):
            ssm_module.selective_scan = selective_scan_ref
            try:
                return M.prefill(params, tokens, cc, ctx_f, attn_impl="dense")
            finally:
                ssm_module.selective_scan = selective_scan

        t0 = time.perf_counter()
        outs["plain"] = plain(c)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if anchored:
            c32 = dataclasses.replace(c, dtype="float32")
            outs["kernel32"], kernel32_ms, _, variants32 = kernel_run(c32)
            outs["plain32"] = plain(c32)

        def pick(run, key):
            logits, cache = outs[run]
            return logits if key == "logits" else cache[key]

        errs, lines = {}, []
        for key in ["logits"] + [k for k in ("k", "v", "conv", "h") if k in outs["kernel"][1]]:
            a, r = pick("kernel", key), pick("plain", key)
            err, good = worst(a, r, dtype_tol(torch.bfloat16))
            e = errs[key] = dict(max_abs=err, rel_l2=rel_l2(a, r), ref_rms=float(r.float().pow(2).mean().sqrt()))
            line = f"{key}: bf16 max err {err:.3g}, rel L2 {e['rel_l2']:.3g}, ref RMS {e['ref_rms']:.3g}"
            if not anchored:
                bad = not good or e["rel_l2"] > MAX_REL_L2
            else:
                a32, r32 = pick("kernel32", key), pick("plain32", key)
                tol32 = dtype_tol(torch.float32, atol_scale=50.0)
                e["f32_max_abs"], good32 = worst(a32, r32, tol32)
                e["f32_rel_l2"] = rel_l2(a32, r32)
                e["plain_rel_l2_vs_f32"] = rel_l2(r, r32)
                e["kernel_rel_l2_vs_f32"] = rel_l2(a, r32)
                ratio = e["kernel_rel_l2_vs_f32"] / e["plain_rel_l2_vs_f32"]
                bad = not good32 or e["f32_rel_l2"] > MAX_REL_L2 or ratio > ANCHOR_RATIO
                line += (f"; float32 max err {e['f32_max_abs']:.3g} (rtol, atol {tol32}), rel L2 "
                         f"{e['f32_rel_l2']:.3g}; rel L2 against the plain float32 path: plain bf16 "
                         f"{e['plain_rel_l2_vs_f32']:.4g}, kernel bf16 {e['kernel_rel_l2_vs_f32']:.4g} "
                         f"(ratio {ratio:.3f} <= {ANCHOR_RATIO})")
            if bad:
                raise Failed(f"long prefill {c.name}: {key} of the kernel path disagree with the plain path: {e}")
            lines.append(line)
        gate = (f"bf16 elementwise (rtol, atol) {dtype_tol(torch.bfloat16)} and rel L2 <= {MAX_REL_L2}"
                if not anchored else "float32 elementwise and rel L2; bf16 anchored to float32")
        extra = dict(kernel32_ms=kernel32_ms, variant_launches32=variants32) if anchored else {}
        log(f"long prefill {c.name} {BATCH}x{LONG} bf16: kernel path {kernel_ms:.2f} ms, plain path "
            f"{plain_ms:.2f} ms; launches {got_counts}, by kernel { {k: n for k, n in got_variants.items() if n} }"
            + (f"; float32 kernel path {kernel32_ms:.2f} ms, by kernel "
               f"{ {k: n for k, n in variants32.items() if n} }" if anchored else "")
            + f"; gate: {gate}; " + "; ".join(lines))
        return dict(kernel_ms=kernel_ms, plain_ms=plain_ms, launches=got_counts, variant_launches=got_variants,
                    err=errs, **extra)

    # ---- phase 6: serve SmolLM-135M at full width on a 10%-faulty chip ----
    params = M.init_params(cfg, 0, device=dev)
    for dtype, atol_scale in (("bfloat16", 10.0), ("float32", 50.0)):
        serve(dataclasses.replace(cfg, dtype=dtype), params, atol_scale, analyses=dtype == "bfloat16")

    # ---- phase 7: SmolLM long prefill through the flash kernel ------------
    long_report = {cfg.name: long_prefill(cfg, params, anchored=False)}
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 8: serve falcon-mamba-7b at full width ----------------------
    t0 = time.perf_counter()
    params = M.init_params(falcon, 0, device=dev)
    torch.cuda.synchronize()
    log(f"falcon-mamba-7b: {sum(p.numel() for p in params.parameters()) / 1e9:.3f} G fp32 parameters "
        f"initialized on the card in {time.perf_counter() - t0:.2f} s")
    # 64 layers of bf16 rounding move the plain path itself by more than the
    # table's atol from its float32 self: bf16 takes the anchored gate, and a
    # float32 serve holds the kernels and the decode recurrence elementwise
    serve(falcon, params, 10.0, elementwise=False)
    serve(dataclasses.replace(falcon, dtype="float32"), params, 50.0)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 9: serve hymba-1.5b at full width ---------------------------
    params = M.init_params(hymba, 0, device=dev)
    serve(hymba, params, 10.0, elementwise=False)
    serve(dataclasses.replace(hymba, dtype="float32"), params, 50.0)

    # ---- phase 10: hymba long prefill ---------------------------------------
    long_report[hymba.name] = long_prefill(hymba, params, anchored=True)
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 11: eFAT on the card -----------------------------------------
    efat_report = efat_phase(torch, log)

    # ---- phase 12: LM fault-aware training on the card ----------------------
    lm_report = lm_phase(torch, log)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 13: continuous serving with online fault detection -----------
    cont_report = continuous_phase(torch, log, profile=args.profile)

    # ---- phase 14: fleet serving ------------------------------------------------
    fleet_report = fleet_phase(torch, log, profile=args.profile)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 15: the rest of the model zoo at full width ------------------------
    # qwen3-0.6b, all 28 layers (qk_norm, head dim 128, the tied 151,936-row unembed read as
    # embed.T): a dense decoder, through phases 6 and 7's gates; bf16 takes the anchored gate
    t0 = time.perf_counter()
    before = dict(variant_launches)
    params = M.init_params(qwen, 0, device=dev)
    serve(qwen, params, 10.0, elementwise=False)
    serve(dataclasses.replace(qwen, dtype="float32"), params, 50.0)
    long_report[qwen.name] = long_prefill(qwen, params, anchored=False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    qwen_s = time.perf_counter() - t0
    zoo_report = zoo_phase(torch, log)
    zoo_report["seconds"][qwen.name] = qwen_s
    for k, n in variant_launches.items():  # qwen3's launches are the phase's too
        zoo_report["launches"][k] = zoo_report["launches"].get(k, 0) + n - before[k]

    # ---- phase 16: the record -----------------------------------------------
    def gemm_sum(arch, dtype, m, layers_only=False):
        """One step's masked GEMMs at M = m, each launch timed alone, times its uses."""
        shapes = arch.gemm_shapes()
        rows = [mm_rows[(arch.name, dtype, m, i)] for i in range(len(shapes) - int(layers_only))]
        keys = [k for k, v in rows[0].items() if k.endswith("ms")]
        return {key: sum(r[key] * r["uses"] for r in rows) for key in keys}

    def bound_by(st, prefix=""):
        """The side of a summed bound that weighs more."""
        return "bytes" if st[f"{prefix}bytes_ms"] >= st[f"{prefix}ops_ms"] else "operations"

    steps = {arch.name: gemm_sum(arch, "bfloat16", BATCH) for arch in (cfg, falcon, hymba)}
    for name, st in steps.items():
        per_step = sum(uses for _, _, uses in get_arch(name).gemm_shapes())
        log(f"decode step {name} (bf16, M={BATCH}), {per_step} masked GEMMs as kernel mode runs them "
            f"(decode kernel, fp32 master read in place, no cast): {st['f32w_ms']:.4f} ms, bound "
            f"{st['f32w_bound_ms']:.4f} ms; path-level yardstick, cast fp32->bf16 + torch.matmul on "
            f"pre-masked w: {st['cast_matmul_ms']:.4f} ms ({st['cast_ms']:.4f} + {st['library_ms']:.4f}); "
            f"decode kernel on a bf16 copy {st['ms']:.4f} ms (bound {st['bound_ms']:.4f}); v1 on a bf16 copy "
            f"{st['v1_ms']:.4f} ms; plain {st['plain_ms']:.4f} ms")
    prefills = {arch.name: gemm_sum(arch, "bfloat16", BATCH * LONG, layers_only=True) for arch in (cfg, hymba)}
    for name, st in prefills.items():
        log(f"long-prefill layer GEMMs {name} (bf16, M={BATCH * LONG}), once per layer as kernel mode runs "
            f"them (mma kernel, fp32 master in place): {st['f32w_ms']:.4f} ms, bound {st['f32w_bound_ms']:.4f} "
            f"ms; bf16 copy {st['ms']:.4f} ms; v1 {st['v1_ms']:.4f} ms; torch.matmul on pre-masked w "
            f"{st['library_ms']:.4f} ms; cast + torch.matmul {st['cast_matmul_ms']:.4f} ms")
    # float32 (v1) at the path level: each model's decode step, and hymba's long-prefill layer GEMMs
    f32_steps = {arch.name: gemm_sum(arch, "float32", BATCH) for arch in (cfg, falcon, hymba)}
    f32_prefills = {hymba.name: gemm_sum(hymba, "float32", BATCH * LONG, layers_only=True)}
    for name, st in f32_steps.items():
        per_step = sum(uses for _, _, uses in get_arch(name).gemm_shapes())
        log(f"decode step {name} (float32, M={BATCH}), {per_step} masked GEMMs through v1: {st['ms']:.4f} ms, "
            f"bound {st['bound_ms']:.4f} ms ({bound_by(st)}); torch.matmul on pre-masked fp32 w "
            f"{st['library_ms']:.4f} ms; plain {st['plain_ms']:.4f} ms")
    for name, st in f32_prefills.items():
        log(f"long-prefill layer GEMMs {name} (float32, M={BATCH * LONG}), once per layer through v1: "
            f"{st['ms']:.4f} ms, bound {st['bound_ms']:.4f} ms ({bound_by(st)}); torch.matmul on pre-masked "
            f"fp32 w {st['library_ms']:.4f} ms")
    # hymba's float32 long prefill through the kernels, split by kernel (each launch timed alone,
    # L2 cold) and the rest (RMSNorm, RoPE, the KV ring, the host)
    h32 = long_report[hymba.name]["kernel32_ms"]
    h_unembed = mm_rows[(hymba.name, "float32", BATCH, len(hymba.gemm_shapes()) - 1)]["ms"]
    h_parts = dict(gemms=f32_prefills[hymba.name]["ms"] + h_unembed,
                   flash=hymba.num_layers * fa_rows[("float32", hymba.name, LONG, "window1024")]["ms"],
                   scan=hymba.num_layers * scan_rows["float32 4x2048x3200x16"]["ms"])
    h_parts["rest"] = h32 - sum(h_parts.values())
    log(f"long prefill {hymba.name} float32 through the kernels: {h32:.2f} ms = " + " + ".join(
        f"{k} {v:.2f}" for k, v in h_parts.items()) + " ms (launches timed alone, L2 cold)")
    f32_step = f32_steps[cfg.name]
    fa = fa_rows[("bfloat16", cfg.name, LONG, "causal")]
    fa32 = fa_rows[("float32", cfg.name, LONG, "causal")]
    sc = scan_rows["bfloat16 4x128x8192x16"]
    dec = da_rows[("smollm-b4", "bfloat16", LONG)]
    pg = pg_rows["smollm bfloat16"]
    mm_src = dict(route="cuda", source="src/repro_torch/kernels/csrc/masked_matmul.cu",
                  replaces="src/repro/kernels/masked_matmul/masked_matmul.py:66", max_abs_err=mm_err)
    fa_src = dict(route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
                  replaces="src/repro/kernels/flash_attention/flash_attention.py:110", max_abs_err=fa_err)
    dstep, pstep = steps[cfg.name], prefills[cfg.name]

    lm_launches = lm_report["deploy"]["launches"]
    # the population evaluations in kernel mode (phases 11 and 12, stage "sharded"): chip-batched v1
    pop_eval_launches = efat_report["deploy_batched"]["v1"] + lm_report["sharded"]["launches"]["v1"]
    pop_eval_err = max(efat_report["deploy_batched"]["parity_err"], lm_report["sharded"]["parity_err"])
    # compute="sharded"'s kernel-mode evaluations (phases 11 and 12): one chip-batched v1 a weight piece
    tp_launches = efat_report["tensor_parallel"]["launches"]["v1"] + lm_report["tensor_parallel"]["launches"]["v1"]
    tp_parity = lm_report["tensor_parallel"]["parity"]
    tp_err = max(tp_parity["joined_err"], tp_parity["piece_err"])
    cont_launches = cont_report["launches"]
    fleet_launches = fleet_report["launches_fleet"]
    fleet_err = fleet_report["max_abs_err"]
    fstep = fleet_report["gemm"][str(BATCH)]["step"]
    zoo_launches, zoo_err = zoo_report["launches"], zoo_report["max_abs_err"]
    # the expert-batched GEMM's rows: mixtral's wg at a decode step's M (bf16 on the fp32 master, and
    # float32) and at its serving prefill's M
    zoo_rows = {(r["label"], r["dtype"], r["m"]): r for r in zoo_report["expert_rows"]}
    expert_rows = {"decode": zoo_rows[("mixtral wg", "bfloat16", ZOO_EXPERT_MS[0])],
                   "mma": zoo_rows[("mixtral wg", "bfloat16", ZOO_EXPERT_MS[1])],
                   "v1": zoo_rows[("mixtral wg", "float32", ZOO_EXPERT_MS[0])]}

    def mm_entry(variant):
        """A masked-GEMM variant's source, its worst error over phase 2's
        single-chip cases and phase 14's chip-batched ones, and phase 15's
        launches."""
        return {**mm_src, "max_abs_err": max(mm_err, fleet_err[variant]),
                "max_abs_err_fleet": fleet_err[variant], "launches_zoo": zoo_launches[f"masked_matmul.{variant}"]}

    def expert_entry(variant):
        """The expert-batched launches of one variant: phase 15's count, mixtral's row."""
        r = expert_rows[variant]
        return dict(name=f"masked_matmul.{variant}.experts", **{**mm_src, "max_abs_err": zoo_err[variant]},
                    launches=zoo_launches[f"masked_matmul.{variant}.experts"],
                    launches_zoo=zoo_launches[f"masked_matmul.{variant}.experts"],
                    ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"])

    # phase 14 (d): the chips x experts GEMM (mixtral's wg, 2 chips x 8 experts) and the chip-batched scan
    # (hymba's prefill, 4 chips, per-chip a and d), with the launches of (d)'s main-path runs
    fam = fleet_report["d"]
    fam_mix, fam_hymba = fam["launches"]["mixtral-8x22b"], fam["launches"]["hymba-1.5b"]
    fam_rows = {(r["label"], r["dtype"], r["m"]): r for r in fam["expert_rows"]}
    fam_scan = next(r for r in fam["scan_rows"] if r["share"] == "per-chip" and r["dtype"] == "bfloat16")
    bwd_row = lm_report["families"]["ssm"]["bwd_row"]  # phase 12's stage "families" (a)

    def chips_expert_entry(variant, m):
        r = fam_rows[("mixtral-8x22b wg", "bfloat16", m)]
        return dict(name=f"masked_matmul.{variant}.chips_x_experts",
                    **{**mm_src, "max_abs_err": fam["max_abs_err"][variant]}, launches=fam_mix["fleet_experts"][variant], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"])

    kernels = [
        dict(name="masked_matmul.decode", **mm_entry("decode"), launches=variant_launches["masked_matmul.decode"],
             launches_by_offset=copied["decode"],
             launches_continuous=cont_launches["decode"], launches_fleet=fleet_launches["decode"],
             ms=dstep["f32w_ms"], plain_ms=dstep["plain_ms"], bound_ms=dstep["f32w_bound_ms"],
             bound_by=bound_by(dstep, "f32w_"), library_ms=dstep["library_ms"]),
        dict(name="masked_matmul.mma", **mm_entry("mma"), launches=variant_launches["masked_matmul.mma"],
             launches_by_copies=copied["mma"],
             launches_lm_eval=lm_launches["masked_matmul"]["mma"],
             launches_continuous=cont_launches["mma"], launches_fleet=fleet_launches["mma"],
             ms=pstep["f32w_ms"], plain_ms=pstep["plain_ms"], bound_ms=pstep["f32w_bound_ms"],
             bound_by=bound_by(pstep, "f32w_"), library_ms=pstep["library_ms"]),
        dict(name="masked_matmul.v1",
             **{**mm_entry("v1"), "max_abs_err": max(mm_err, fleet_err["v1"], pop_eval_err, tp_err)},
             max_abs_err_pop_eval=pop_eval_err, max_abs_err_tensor_parallel=tp_err,
             launches=variant_launches["masked_matmul.v1"],
             launches_efat_deploy=efat_report["deploy"]["v1"], launches_pop_eval=pop_eval_launches,
             launches_tensor_parallel=tp_launches,
             launches_lm_eval=lm_launches["masked_matmul"]["v1"],
             launches_continuous=cont_launches["v1"], launches_fleet=fleet_launches["v1"],
             ms=f32_step["ms"], plain_ms=f32_step["plain_ms"], bound_ms=f32_step["bound_ms"],
             bound_by=bound_by(f32_step), library_ms=f32_step["library_ms"]),
        dict(name=f"masked_matmul.decode.chips{FLEET_CHIPS}", **{**mm_src, "max_abs_err": fstep["max_abs_err"]},
             launches=fleet_launches["decode"], ms=fstep["ms"], plain_ms=fstep["plain_ms"],
             bound_ms=fstep["bound_ms"], bound_by=fstep["bound_by"], library_ms=fstep["library_ms"]),
        *(expert_entry(v) for v in ("decode", "mma", "v1")),
        chips_expert_entry("decode", FLEET_EXPERT_MS[0]),
        chips_expert_entry("mma", FLEET_EXPERT_MS[1]),
        dict(name="flash_attention.mma", **fa_src, launches=variant_launches["flash_attention.mma"],
             launches_lm_eval=lm_launches["flash_attention"]["mma"], launches_zoo=zoo_launches["flash_attention.mma"],
             ms=fa["ms"], plain_ms=fa["plain_ms"], bound_ms=fa["bound_ms"],
             bound_by="operations", library_ms=fa["library_ms"]),
        dict(name="flash_attention.v1", **fa_src, launches=variant_launches["flash_attention.v1"],
             launches_lm_eval=lm_launches["flash_attention"]["v1"], launches_zoo=zoo_launches["flash_attention.v1"],
             ms=fa32["ms"], plain_ms=fa32["plain_ms"], bound_ms=fa32["bound_ms"],
             bound_by="operations", library_ms=fa32["library_ms"]),
        dict(name="selective_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/selective_scan.cu",
             replaces="src/repro/kernels/mamba_scan/mamba_scan.py:54",
             launches=launches["selective_scan"], max_abs_err=scan_err,
             ms=sc["ms"], plain_ms=sc["plain_ms"], bound_ms=sc["bound_ms"],
             bound_by=sc["bound_by"], library_ms=None),
        dict(name=f"selective_scan.chips{fam_scan['chips']}", route="cuda",
             source="src/repro_torch/kernels/csrc/selective_scan.cu",
             replaces="src/repro/kernels/mamba_scan/mamba_scan.py:54",
             launches=fam_hymba["scan_fleet"], max_abs_err=fam["max_abs_err"]["scan"],
             ms=fam_scan["ms"], plain_ms=fam_scan["plain_ms"], bound_ms=fam_scan["bound_ms"],
             bound_by=fam_scan["bound_by"], library_ms=None),
        dict(name="selective_scan_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
             replaces="src/repro/kernels/mamba_scan/mamba_scan.py:54",
             launches=lm_report["families"]["bwd_launches"], max_abs_err=bwd_row["max_abs_err"],
             ms=bwd_row["ms"], plain_ms=bwd_row["plain_ms"], bound_ms=bwd_row["bound_ms"],
             bound_by=bwd_row["bound_by"], library_ms=None),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/decode_attention.py:216",
             launches=tune_launches, max_abs_err=da_err,
             ms=dec["ms"], plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"],
             bound_by=dec["bound_by"], library_ms=dec["library_ms"]),
        dict(name="paged_decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/decode_attention.py:151",
             launches=pg["launches"], max_abs_err=max(r["max_abs_err"] for r in pg_rows.values()),
             ms=pg["ms"], plain_ms=pg["plain_ms"], bound_ms=pg["bound_ms"],
             bound_by=pg["bound_by"], library_ms=pg["library_ms"]),
    ]
    for k in kernels:  # the tuner's launches (phase 5's spaces), by kernel variant
        if k["name"] in space_launches:
            k["launches_tune"] = space_launches[k["name"]]
    for k in kernels:
        if not k["launches"] or 0 in (k.get("launches_continuous"), k.get("launches_fleet"), k.get("launches_zoo"),
                                      k.get("launches_pop_eval"), k.get("launches_tensor_parallel")):
            raise Failed(f"{k['name']} was not launched on its main path")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    if profile_lines:
        (OUT_DIR / "profile_serve.txt").write_text("\n".join(profile_lines))
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, serve=serve_report, kernels=kernels, profile=profile_report or None,
        decode_step_gemms=steps, long_prefill_gemms=prefills, mask_pack_ms=pack_ms,
        decode_step_gemms_f32=f32_steps, long_prefill_gemms_f32=f32_prefills, long_prefill_f32_split=h_parts,
        variant_launches=variant_launches,
        masked_matmul_rows=[dict(arch=k[0], dtype=k[1], m=k[2], **v) for k, v in mm_rows.items()],
        flash_rows=[dict(dtype=k[0], model=k[1], s=k[2], case=k[3], **v) for k, v in fa_rows.items()],
        scan_rows=[dict(case=k, **v) for k, v in scan_rows.items()],
        decode_rows=[dict(cell=k[0], dtype=k[1], valid=k[2], **v) for k, v in da_rows.items()],
        decode_lattice=[dict(cell=k[0], dtype=k[1], **v) for k, v in lattice_report.items()], paged_rows=pg_rows, tune=tune_report,
        tune_max_abs_err=space_err, lint=lint_stats, analyses=analysis_report,
        long_prefill=long_report, efat=efat_report, lm_fat=lm_report, continuous=cont_report, fleet=fleet_report,
        zoo=zoo_report,
        seconds=time.perf_counter() - t_start,
    ), indent=1))
    log("kernels: " + ", ".join(f"{k['name']} launches={k['launches']} max_abs_err={k['max_abs_err']:.3g}"
                                for k in kernels))
    log(f"masked_matmul.decode ms/plain_ms/library_ms/bound_ms: one bf16 SmolLM-135M decode step's "
        f"{sum(u for _, _, u in cfg.gemm_shapes())} launches at M={BATCH}, the fp32 master read in place "
        f"(plain and torch.matmul on the bf16 copy); masked_matmul.mma: SmolLM-135M's layer GEMMs at "
        f"M={BATCH * LONG}, once per layer, fp32 master; masked_matmul.v1: the float32 decode step; "
        f"masked_matmul.decode.chips{FLEET_CHIPS}: the same decode step for {FLEET_CHIPS} chips, one chip-batched launch "
        f"a GEMM (launches: phase 14's); masked_matmul.<variant>.experts: one expert-batched launch of mixtral-8x22b's "
        f"wg (8 x 6144 x 16384, one mask) at M={ZOO_EXPERT_MS[0]} (decode, v1 in float32) and {ZOO_EXPERT_MS[1]} (mma) "
        f"a expert (launches: phase 15's); masked_matmul.<variant>.chips_x_experts: one chips x experts launch "
        f"of mixtral-8x22b's stacked wg (2 chips x 8 experts, one mask a chip) at M={FLEET_EXPERT_MS[0]} (decode) "
        f"and {FLEET_EXPERT_MS[1]} (mma) an expert (launches: phase 14 (d)'s mixtral fleet); "
        f"selective_scan.chips{fam_scan['chips']}: one chip-batched launch at hymba-1.5b's prefill, "
        f"{fam_scan['chips']} chips x 4x128x3200x16, bf16 u, per-chip a and d (launches: phase 14 (d)'s hymba "
        f"fleet); selective_scan_bwd: one chip-batched launch at falcon-mamba-7b's population fit, "
        f"{' x '.join(map(str, bwd_row['shape']))} (chips x rows x L x D x N), float32 (launches: phase 12's stage "
        f"families' fits); launches_zoo: phase 15's main-path launches; launches_pop_eval: "
        f"the chip-batched v1 launches of phases 11 and 12's kernel-mode population evaluations; "
        f"launches_tensor_parallel: their compute='sharded' runs' (one a weight piece); "
        f"flash_attention.mma / .v1: one launch at 4x9x2048^2 causal, bf16 / float32; selective_scan: one launch at 4x128x8192x16, bf16 u (falcon-mamba-7b's "
        f"serving prefill); decode_attention: one launch at SmolLM-135M's b=4 decode over 2048 "
        f"int8 tokens, bf16 q, the heuristic bkv (launches: the tuner's); paged_decode_attention: "
        f"one launch over {PAGED_SLOTS} slots of a paged pool, bf16 q; run time "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
