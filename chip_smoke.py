"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--baseline DIR [DIR ...]]

Phases (any failure exits non-zero; no phase swallows its own failure).
[main-filter], [main-dynamic] and [main-bf16] fit [main]'s fleet at its g
and n_iter again through their CLIs; the G greedy of those fits is not run
again but copied from [main]'s (``reuse_g_greedy``, a ``[reuse]`` line
each), so that the run stays well inside its time limit:

1. build   — compile the hand-written CUDA kernels (every csrc/*.cu, one
             nvcc process per source, all started together) from this
             checkout and load them; print each kernel's registers and
             spills (``nvcc -Xptxas -v``) and its FFMA count
             (``cuobjdump -sass``): a bf16-signal kernel must have none.
2. kernels — hold each kernel against its plain PyTorch version on the card:
             the G kernels (csrc/butterfly.cu) and the T kernels
             (csrc/shear.cu), chain, operator and bank, batched and B = 1,
             at n in {16, 48} on tables of small port fits (symmetric and
             directed), R = 130 signal rows (a ragged tile edge), at every
             ladder cut including 0, the chains at both keeps, the banks at
             F in {1, 7, 33} (33 filters split into several filter groups
             per row tile where the grid needs them; the geometry of each
             check is printed).  The same checks run on the same tables
             cast to bf16 (the bf16 forms of all 12 entry points, G chains
             now at both keeps), each bf16 form also against its own f32
             form on the widened tables (max|dy| printed).  Then all of
             it again on a bf16 signal (x cast to bf16): the bf16-signal
             forms of all 12 entry points on the f32 tables and on the
             bf16 ones, held bitwise to their plain versions, and each on
             the bf16 tables equal to itself on the widened f32 tables.
             Then the batch split at both table precisions and both
             signal dtypes: a batch of 7 at a grid limit forced down to 3
             matrices (launcher._GRID_B) launches each family's chain,
             operator and bank three times, and each equals its unsplit
             launch bitwise.
3. main    — the port's main path at a realistic size, through the CLI entry
             point: ``python -m repro_torch.launch.serve --fgft`` with B = 64
             community graphs, n = 256, g = 2 n log2 n = 4096, R = 256,
             tiers full/balanced/draft.  Launch counters are zeroed just
             before and read just after; both batched entry points must
             have launched.  The full tier's relative error must be < 0.05
             and equal the dense ||L - U diag(s) U^T||^2 / ||L||^2 within
             1e-3 relative, and the served output must match the plain
             version.
3b. main-filter — the filter-bank path through the CLI: ``serve --fgft
             --filter heat,tikhonov,wavelets:4`` on the same fleet (B = 64,
             n = 256, g = 4096, R = 256, F = 7).  Counters are zeroed just
             before and read just after: ``batched_sym_filter_bank_apply``
             must have launched.  The served (B, F, R, n) bank must match
             its plain version, each filter the operator kernel with that
             filter's gains (``engine.step``), and each filter the dense
             ``eigh`` filtering within 2 max(Lip(h), 1) delta + 5e-3 per
             graph (delta = sqrt(relative error); the worst ratio is
             printed).
4. fgft    — the single-graph path at the same width: ``build_fgft`` on one
             community graph (n = 256, g = MAIN["single_g"] = 2048, n_iter
             = 1), then ``FGFT.analysis``,
             ``synthesis``, ``project`` and the same bank through
             ``ApplyPlan(mode="bank")`` (the single-matrix entry points,
             launched as B = 1).  Counters are zeroed just before and read
             just after; the three single-matrix entry points must have
             launched.  Relative error < 0.05, synthesis(analysis(x)) = x,
             the bank equal to its plain version.
5. main-directed — the directed main path, through the CLI entry point:
             ``serve --fgft --directed`` with B = 64 directed community
             graphs, n = 256, g = 4096, R = 256, the same tiers, the T fit
             at ``n_iter`` 1 (the engine's default 3 is the run's largest
             phase; 2 took 152.2 s on a slow host).  Counters are zeroed
             just before; then
             ``basis.apply(x, inverse=True)``
             and ``basis.apply(.)`` round-trip the signals; counters are
             read just after: ``batched_gen_operator_apply`` and
             ``batched_shear_apply`` must have launched.  Mean full-tier
             relative error < 0.05 and equal to the dense
             ||L - T diag(c) T^-1||^2 / ||L||^2 (T from ``t_to_dense``, plain
             torch) within 1e-3 relative; the served output equals the plain
             version bitwise; the round trip returns x within a tolerance derived
             from cond(Tbar) (printed with it).  Then the directed bank on
             the same fitted basis (no second T fit): an engine with
             ``filters=`` and the same bank spec, counters zeroed just before
             its steps; ``batched_gen_filter_bank_apply`` must have
             launched, the bank must equal its plain version and each
             filter the operator kernel, bitwise.
5b. main-ragged — the heterogeneous fleet through the CLI: ``serve --fgft
             --ragged --graphs 64 --graph-sizes 64,100,180,256 --transforms
             1024`` (16 community graphs of each size in buckets of width 64,
             128 and 256 with 16, 16 and 32 graphs, g = 192, 448 and 1024:
             w log2 w / 2, a quarter of the main path's g at the largest
             width, for the run's time limit), R = 256,
             the same tiers.  Counters are zeroed just before and read just
             after; both batched G entry points must have launched.  Each
             graph's relative error equals its dense recomputation on the
             cropped block within 1e-3 relative (mean < 0.05); each bucket's
             served output matches the plain operator program on the same
             tables (G tolerance), each graph's answer is its cropped bucket
             row and the bucket's pads are 0; ``apply`` passes pad
             coordinates through bitwise (synthesis, analysis, round trip)
             and ``project`` with the heat response gives exactly 0 there.
             Then the router is saved and loaded (times printed) with the
             bank spec as a ``filters=`` override: the restored tables and
             every tier's steps are bitwise equal to the saved router's,
             and the restored router serves ``step_bank`` (counters zeroed
             just before its timed steps: one bank launch per bucket and
             step), each bucket's bank held to its plain version and each
             filter to the operator kernel, pads 0.  Last a small directed
             ragged fleet (sizes 12, 20, 32; n_iter = 1): the T operator,
             chain (both legs) and bank of every bucket bitwise equal to
             their plain versions, and the pads passed through bitwise.
5c. main-dynamic — the evolving-fleet path (after [main-ragged], whose
             saved router it loads), each part driven with the counts
             zeroed just before and read just after, comparisons not
             counted: a. ``serve --fgft --dynamic --graphs 64 --graph-n
             256 --transforms 4096 --signals 256 --update-rounds 4
             --churn 0.002`` (default tiers and policy) through
             ``serve_fgft_dynamic``; after each round the served full tier
             against the plain operator, the full-tier relative error
             through the operator kernel (and the objective after a
             structural fit) against the dense recomputation within 1e-3
             relative, the entry-stream cache's hits and misses; then the
             drift probe (R = 8), the Lemma-1 refresh and a full-tier step
             timed on the pinned tables.  b. REFRESH, then EXTEND at full
             width on the same engine (2% churn, thresholds set from the
             measured drift), every kernel of the path (operator at R =
             256 and R = 8, chain on the identity, the F = 7 bank served
             on the extended basis) against its plain version on the
             pinned, extended tables.  c. EXTEND then a budget-forced
             REFIT on a small fleet (B = 4, n = 32): the chain returns to
             g0, ``extends_since_refit`` is 0.  d. a dynamic engine on
             [main-directed]'s basis (no new fit), one directed round,
             EXTEND; every tier bitwise equal to its plain version.
             e. [main-ragged]'s router loaded with ``dynamic=True``, graphs
             of two of its three buckets updated, ``maintain(dirty_only=
             True)``: only those buckets tick and only their graphs'
             versions move; pads 0 from ``project``.  The operator, chain,
             bank and T operator batched entry points must have launched;
             each ``kernels`` row carries ``dynamic_launches``.
5d. main-bf16 — bf16 table storage (after [main-dynamic]), each part
             driven with the counts zeroed just before and read just
             after, comparisons not counted: a. ``serve --fgft --precision
             bf16 --filter heat,tikhonov,wavelets:4 --graphs 64 --graph-n
             256 --transforms 4096 --signals 256`` (one G fit): the bank
             against its plain version, each filter against dense ``eigh``
             within its bound; b. engines at ``precision="bf16"`` on
             [main]'s and [main-directed]'s bases (``basis=``, no fit):
             every tier and the bank against the plain versions, the full
             tier and the bank against the f32 engine's (relative
             deviation < 0.03), graph-transforms/s and responses/s beside
             the f32 ones, an ``apply`` round trip at bf16; c.
             [main-ragged]'s saved router loaded at bf16: served buckets
             against plain, pads bitwise through ``apply`` and 0 from
             ``project``; d. a dynamic engine at bf16 on [main]'s basis,
             one forced REFRESH: the bf16 cast is kept and every step after
             the swap hits the entry-stream cache; e. the single-graph
             paths at bf16.  Every bf16 form must have launched; the bf16
             rows of the ``kernels`` line carry these launches.
5e. main-async — the async front end (after [main-bf16]), on the tables
             the earlier phases fitted (no fit at full width), each part
             driven with the counts zeroed just before and read just
             after, comparisons not counted: a. [main]'s basis with its
             tiers and the F = 7 bank behind ``AsyncFGFTService(
             max_queue=128, max_batch=8)``, 2048 tier and 512 bank
             requests of R = 8 rows from 16 closed-loop tenants: every
             answer equal to ``step_versioned`` / ``step_bank_versioned``
             on the request's rows alone (G within the G tolerance, the
             largest max|dy| and whether it was bitwise printed),
             ``batched_sym_operator_apply`` launches equal to the tier
             dispatches and ``batched_sym_filter_bank_apply`` launches to
             the bank dispatches, ``plan_compile`` spans equal to the
             plan-cache misses (cache cleared first), each request's
             queue, batch and execute spans sharing their endpoints with
             the next one and with the request span, exactly (the
             service's clock is rounded to 2^-20 s so that the sums are
             exact); requests/s, p50/p99 of queue, service and total per
             tier, mean occupancy, and the traced/untraced requests/s
             ratio (the same load with ``obs.configure(enabled=False)``,
             printed, not gated).  b. [main-directed]'s basis, 512
             requests, bitwise.  c. [main-ragged]'s saved router (no
             fit), 512 requests over its three buckets, one launch per
             dispatch, pads 0 in every bucket output.  d. a dynamic
             engine on [main]'s basis, a churn thread at 0.002 and the
             maintainer at a 0.05 s interval (refresh threshold 0.002,
             the others out of reach, hysteresis 1: REFRESH fires, and
             an EXTEND comes only by escalation; the churn stops when the
             first EXTEND starts, so there is at most one), 2048
             requests: at least one swap, versions non-decreasing in
             dispatch order, no failed request, the final full tier
             against plain, a profiled REFRESH tick's kernels on other
             CUDA streams than the serving launches' (in a process of its
             own on the saved [main] basis: a profiler that has taken the
             earlier phases' traces can lose a whole tick), total p99
             while a tick runs against idle.  e. ``serve --fgft --serve-async
             --dynamic --graphs 8 --graph-n 64 --load-requests 256
             --load-workers 4 --trace T --metrics-dir M``: T loads as a
             Chrome trace, M's metrics.json and metrics.prom hold
             ``service_requests_total`` and ``plan_cache_misses_total``.
             The operator, bank, T operator and chain batched entry
             points must have launched; each ``kernels`` row carries
             ``async_launches``.
5f. main-bf16x — bf16 signals (after [main-async]) on the tables that
             [main], [main-filter], [fgft], [main-directed] and
             [fgft-directed] fitted (no fit), one bf16 block of R = 256,
             each part driven with the counts zeroed just before and read
             just after, comparisons not counted: a. f32 tables, as a
             user serves a bf16 block: ``FGFTServeEngine.step`` at every
             tier and ``step_bank`` (F = 7), ``SpectralFilterBank.apply``,
             ``ApproxEigenbasis.apply`` (both ways) and ``project``, and
             the single graph's ``FGFT.analysis``, ``synthesis``,
             ``filter`` and bank, in both families; b. the same tables
             cast to bf16 through the 12 entry points.  Every answer is
             bf16 and bitwise equal to its plain version on the same
             block; each tier equals ``project`` at the tier and the bank
             the basis's own bank.  max|dy| / max|y| against the same
             block's f32 answer is printed per tier, bank and family, not
             gated.  All 24 bf16-signal forms must have launched.
5g. main-core — the rest of repro.core and repro.kernels (after
             [main-bf16x]; no fleet fit): a. the paper's baselines on the
             first 4 graphs of [main]'s fleet (n = 256, g = 4096; each
             greedy method on the stack of 4, one chain a graph):
             ``truncated_jacobi``, ``factorize_orthonormal`` of the exact
             eigenvectors with its Lemma-1 spectrum, ``rank_r_symmetric``
             at r = 3g / 2n = 24 (matched flops), beside [main]'s fit:
             each relative error ||L - U diag(s) U^T||^2 / ||L||^2 and
             each baseline's seconds printed; U orthonormal to 1e-4,
             Jacobi's spectrum equal to diag(U^T L U) within 1e-4 max|L|,
             and the greedy loops run under
             ``torch.cuda.set_sync_debug_mode("error")`` (no host sync).
             b. ``compress_linear`` of a seeded synthetic square projection
             (decaying spectrum, as examples/compress_projection.py builds
             one) at n = 1024, the d_model of seamless-m4t-large-v2 (the
             narrowest config in src/repro/configs/), g_orth = g_sym =
             2048, n_iter = 1; ``compressed_linear_apply`` over 4096 token
             rows, counters zeroed just before three calls and read just
             after: exactly one ``sym_operator_apply`` and one
             ``butterfly_apply`` launch a call.  The output equals its plain
             version (G tolerance; each kernel also against its own plain
             version) and x W_hat^T of the dense factors within 1e-4
             relative; ||y - x W^T||^2 / ||x W^T||^2 beside the reported
             rel_err, ms a call against ``torch.matmul(x, W.T)`` and the
             geometries at n = 1024 printed.  c. ``butterfly_apply`` at n =
             1024 with ``fft_pattern(1024)``, forward and backward: the
             mixing orthonormal to 1e-5, the gradients equal to the same
             call on the CPU within 1e-4 relative; ``ef_roundtrip`` of a
             1024 x 4096 leaf at ``make_spec(1024, 0.125)``: out + new_err
             == grad + err within 1e-5 relative, and the identity at ratio
             1.  d. on the run's own tile cache (build/autotune.json): all
             12 entry points, and the batched G operator's bf16-table and
             bf16-signal forms, at block_b in (32, 64, 128, 256) bitwise
             equal to their block_b=None launches; ``autotune_block_b`` on
             [main]'s batched G operator and chain plans and
             [main-filter]'s bank plan (timings, choice and the geometry
             at each candidate printed); after ``clear_plan_cache()`` a
             plan with block_b=None launches the cached tile;
             ``autotune_measurements_total`` rose by 3.  The phase's
             seconds are printed; each ``kernels`` row carries
             ``core_launches``.
5h. main-lm — the LM serving path (after [main-core]; random weights from
             seed 0, bf16 compute on f32 parameters, TF32 off; every line
             carries the card's name and power limit): a. ``serve --arch
             qwen2-1.5b --requests 8 --batch-slots 4 --prompt-len 32
             --gen-len 16`` through ``serve.main`` at the full config (28
             layers, d 1536, vocab 151936): 8 x 16 tokens, all in [0,
             vocab), the served line printed; tokens/s, prefill ms a
             request, decode ms a step, ``max_memory_allocated``, and a
             decode step's kernel launches and device-busy ms
             (torch.profiler) beside its bytes bound, reckoned from the
             shapes (every weight the step reads once, its cache, the
             logits) at 3.35 TB/s.  c. the same prompts through a 4-slot
             engine on the same weights (seed 0 again, checked equal),
             each request's logits at every step held to the request
             alone in a 1-slot engine fed the same tokens, within the
             bf16 bound; the greedy tokens that agree are counted, not
             gated.  b. prefill + one decode against ``forward`` of the
             extended sequence (tests/test_models.py's check) for
             qwen2-1.5b and gemma2-27b at full width with 2 layers, in
             bf16 (bf16 cache) and f32 (f32 cache; the JAX package's bf16
             cache at f32 printed, not gated).  e. one 2048-token prompt
             prefilled chunked (two KV chunks of 1024, skipping) against
             ``attn_impl="naive"``, gated in f32, printed in bf16 (the two
             paths round the attention output in different places at
             every layer: ~5% of max|logits| at 28 layers).  d. qwen2-1.5b at full width, 2
             layers, f32: parameters made on the CPU and copied to the
             card, prefill and two decodes on the card against the port
             on the CPU (f32 cache; with the bf16 cache printed, not
             gated: which K/V entries round a bf16 ulp apart depends on
             each device's sum order).  Bounds: 2e-2 x max(1,
             max|logits|) in bf16, 1e-4 x ... in f32.  The 12 entry
             points' counters are zeroed before and read after: none
             may have launched (``lm_launches`` of each ``kernels``
             row).  The phase's seconds are printed.
5i. main-lm-families — the MoE, SSM, hybrid, vision and audio families
             (after [main-lm]; LMF; random weights from seed 0 with the
             cross-attention gates set to 1): a. ``serve --arch``
             mamba2-780m and recurrentgemma-2b at full config and depth,
             [main-lm] a's lines.  b. decode and prefill against
             ``forward`` for mamba2-780m, recurrentgemma-2b and
             seamless-m4t-large-v2 at full depth, qwen3-moe-30b-a3b at 2
             layers and llama-3.2-vision-90b at 5 (one cross5
             super-layer), all at full width, bf16 and f32 (f32 cache),
             on a drawn memory for vision and audio; each model's
             parameters and ``max_memory_allocated`` printed.  c. four
             requests through 4 slots against each alone in 1 slot on
             the same memory.  d. each family (mamba2 2
             layers, recurrentgemma 3, seamless 2 + 2, qwen3-moe 2,
             vision 5) in f32 with an f32 cache on the card against the
             CPU, the CPU's copy in one pinned host block.  kimi-k2-1t-a32b
             (KIMI, ROADMAP A6e): one layer at full width, all 384 experts
             in the recipe's bf16 parameters (38.8 GB; the f32 draw of
             each leaf peaks at 61.3 GB, printed beside the arithmetic;
             its compute copies are the parameters, 0 B, checked): b and
             c in bf16, the decode step's ms, launches and busy ms beside
             its bytes bound, and the bytes its dispatch reads (every
             expert's); then one f32 draw at 16 experts (12.7 GB) for b in
             f32 (gated on the rows whose compared token routes alike on
             both sides, the only rows whose logits read no other token's
             MoE output at one layer) and d.  e.
             mamba2-780m and recurrentgemma-2b at 2 layers, f32: a
             256-token ``forward`` (chunked SSD / scanned RG-LRU) against
             256 single-token decode steps, and their states.  Bounds as
             [main-lm]'s; MoE is printed, not gated, in b (beyond one
             layer) and c (forward, prefill and decode group tokens
             differently, and capacity couples the slots of a decode
             step; the dropped (token, expert) pairs are printed), and d
             gates an MoE call only where the card's and the CPU's top-k
             sets all agree.  None
             of the 12 entry points may launch (``lm_families_launches``
             of each ``kernels`` row).  The phase's seconds are printed.
5j. main-train — the LM training path (after [main-lm-families]; TRAIN;
             random weights from a seed): a. ``train --arch qwen2-1.5b
             --steps 6 --seq-len 256 --global-batch 8 --warmup 2
             --log-every 2 --ckpt-every 1000`` at full size through
             ``train.run``, the checkpoint under ``build/`` (removed
             after): finite logged losses, the median step ms of steps
             2-8 and tok/s, one more step's kernel launches and
             device-busy ms (torch.profiler) beside its FLOP bound (6 N
             T, N without the embedding table, a gather: forward and
             backward, at the card's dense bf16 rate; 8 N T with the
             remat recompute), ``max_memory_allocated``, the final
             checkpoint's GB and seconds to commit.  b. 2 layers at full
             width on a repeated motif, 30 steps of AdamW at lr 3e-3: the
             last loss at least 0.5 under the first (the JAX package's
             tests/test_models.py gate).  c. qwen2-1.5b and mamba2-780m at
             full width, 2 layers, f32, TF32 off, B 2 x S 64: the loss,
             every gradient leaf and the parameters after one AdamW update
             on the card against the CPU within 1e-4 x max(1, max|.|) (a
             gradient leaf within 1e-4 x max(1e-3, max|g|), its own
             scale).  d.
             4 layers at full width, ``remat_block`` 4 against no remat:
             the gradients within the same bound (and whether bitwise),
             both peaks printed.  e. the ``--smoke`` CLI on the card: 3
             steps and ``--resume auto`` to 6 against 6 at once (the
             parameters bitwise), and ``--grad-compress-ratio 0.25``.
             kimi-k2-1t-a32b (KIMI, ROADMAP A6e), one layer at full
             width: f. (i) c's check in f32 at 16 experts, B 2 x S 64,
             no remat on either side, the host's MemAvailable read first
             (the CPU side holds ~54 GB; short of it, the gradients
             alone): the loss and every gradient leaf at c's bounds, both
             sides updated leaf by leaf, each parameter entry within
             ``adamw.first_step_tolerance`` of c's gradient and norm
             bounds (its reading on the parameters' scale printed).  g.
             (ii) the recipe's step at 64 experts (bf16 parameters and
             moments, 5.3 B parameters), 2 steps of ``make_train_step``
             at B 8 x S 256: every gradient and moment leaf finite, the
             moments bf16, the first loss within 2e-2 x max(1, |loss|) of
             an f32 forward's on the same parameters and batch; step ms,
             tok/s, the second step's launches and busy ms beside 6 N T,
             the peak beside the arithmetic (~70.6 GB).
             None of the 12 entry points may launch (``train_launches``
             of each ``kernels`` row).  The phase's seconds are printed.
5k. main-placed — fleet placement (after [main-train]; PLACED; no fit
             at full width), each part driven with the counts zeroed just
             before and read just after (comparisons not counted): a. the
             [main] basis served by ``FGFTServeEngine(placement=
             single_bucket_placement(mesh, 64))`` on ``make_local_mesh()``
             (one device on a one-card machine) and on 4 logical devices
             of the card (``logical_devices``): every tier's ``step``
             (lowpass) and ``step_versioned`` and the F = 7 bank bitwise
             the unplaced engine's, one launch per shard per dispatch, ms
             per placed dispatch beside the unplaced one.  b. the same on
             the [main-directed] basis (T family).  c. ``pad_batch`` of
             both bases' tables 64 -> 96 rows through chain, operator and
             bank at f32 and bf16 tables: the real rows bitwise the
             unpadded launch, pad rows bitwise their input through the
             chain and exactly 0 through the operator and the bank.
             d. [main-ragged]'s saved router loaded with
             ``placement="auto"`` on ``make_local_mesh()`` and on 4
             logical devices, every tier of every bucket bitwise the
             saved router's; the placed router saved (``placement.json``)
             and loaded back placed, tables and steps bitwise.  e/f. a
             small fleet (B = 8, n = 64, g = 192) fitted unplaced and
             with
             ``fit(mesh=)`` on 4 logical devices (factors, spectrum and
             objective bitwise), then dynamic engines on both fits, one
             placed on the logical devices: a forced REFRESH (no new plan,
             no new entry stream) and a forced EXTEND, tick for tick the
             unplaced engine's, every tier bitwise after each swap.  Each
             ``kernels`` row carries ``placed_launches``; the phase's
             seconds are printed.
5l. main-dryrun — the dry run (after [main-placed]; DRYRUN), the counts
             zeroed just before and read just after: a.
             ``launch/dryrun.py::run_cell`` of qwen2-1.5b train_4k on
             both production meshes (256 and 512 ids on ``meta``; one
             global and one data-shard trace serve both; each cell's
             collectives from its step traced for one id, every id
             counted as it): the single mesh's cell, per-device GB
             against the card's ``total_memory``, ``collective_bytes``,
             ``cross_pod_bytes``, the bytes by kind and the dominant of
             the three terms (every collective key filled); then the
             multi mesh's ``pod_compress`` cell, its cross-pod bytes
             under half of its collective bytes (the JAX test's gate;
             the multi mesh's plain cell is left out for the run's time
             limit).
             b. [main-train]'s configuration (qwen2-1.5b at full size,
             B 8 x S 256, ``remat_block`` 4) predicted on a 1x1 mesh and
             held to one real step on the card: the predicted argument
             bytes equal to the bytes of the state and batch tensors, the
             predicted dot FLOPs within 1% of a ``torch.profiler``
             ``with_flops`` count of the product events (mm, addmm, bmm,
             baddbmm) that launched a kernel, what else the profiler
             counts printed; the predicted peak (arguments + temp) beside
             ``max_memory_allocated`` (not gated).  c. that state and
             batch placed on 4 logical devices of the card, a (2, 2)
             ("data", "model") mesh, through ``sharding_tree``: each
             id's shard bytes equal to the dry run's per-device argument
             bytes, every leaf gathered back bitwise.  None of the 12
             entry points may launch (``dryrun_launches`` of each
             ``kernels`` row); the phase's seconds are printed.
5m. main-sharded — the sharded train step (after [main-dryrun]; SHARDED)
             on logical devices of the card, the counts zeroed just before
             and read just after: a. qwen2-1.5b at full width, 2 layers,
             f32, TF32 off, B 8 x S 256: one step of ``make_train_step``
             on a (2, 2) and a (1, 4) ("data", "model") mesh (at 4 the two
             KV heads are replicated) against the unsharded step on the
             card: the loss within 1e-6 relative, every gradient leaf
             within 1e-5 x max(1e-3, max|g|), the global norm within 1e-5
             relative, each parameter after AdamW (lr 1e-5) within
             ``adamw.first_step_tolerance`` of those bounds, and of the
             unsharded AdamW update of the step's own gradients (the
             parameters against 1e-6 x max(1, max|p|) printed, not
             gated).  b. the full model (28 layers, ``remat_block``
             4, bf16 compute) on the (2, 2) mesh, 2 steps from
             ``placed_train_state``: finite losses, the median step ms
             beside [main-train]'s, kernel launches and device-busy ms a
             step (torch.profiler), each id's state and batch bytes equal
             to the dry run's ``argument_size_in_bytes`` for that mesh,
             ``max_memory_allocated``, one step's collective result bytes
             per id by kind and axes and the JAX terms' per-device
             ``collective_bytes``, and that count equal id by id to the
             representative trace's (the step traced on ``meta`` for one
             id of a (2, 2) mesh, ``dryrun.collective_count``).  c. the
             cross-pod compressed step
             (``make_pod_compressed_train_step``) at full width, 2
             layers, ratio 0.125, 2 steps, on (2, 1, 2) and (2, 2, 2) ("pod",
             "data", "model") meshes: finite losses, ``cross_pod_bytes``
             equal to the count from the leaves' shard shapes and under
             half of the uncompressed reduction's, and on (2, 2, 2) under
             half of ``collective_bytes`` (the JAX test's gate).  d. ``train
             --smoke --model-axis 2`` on 4 logical devices: 3 steps,
             ``--resume auto`` to 6, against 6 at once, every state leaf
             bitwise.  e. one train step of each family beyond the dense
             ones at full width and the least depth its layer pattern
             takes (``SHARDED_FAMILIES``: kimi-k2-1t-a32b at one layer and
             16 experts in f32, fsdp and expert-parallel on (2, 2), its
             loss and gradients only, its values the recipe's bf16 ones,
             then C12's bf16 line: the bf16 sharded step's gradients
             against the unsharded bf16 step's beside twice the unsharded
             bf16 step's distance from the f32 one, printed;
             qwen3-moe-30b-a3b expert-parallel
             and mamba2-780m on (1, 4), recurrentgemma-2b on (2, 2),
             seamless-m4t-large-v2 on (1, 4), llama-3.2-vision-90b on (1,
             4), its loss and gradients only, at B 2), f32, TF32 off, the
             cross-attention gates at 0.5, against the unsharded step on
             the card, its results parked in host memory: a's bounds (the
             gradients of mamba2-780m and llama-3.2-vision-90b held in
             f64, where the unsharded f32 step is itself farther than the
             bound from an f64 step), each id's bytes the dry run's, the
             MoE routes and kept pairs against the unsharded step's; then
             ``train --arch mamba2-780m --smoke --model-axis 2`` resumed
             bitwise.  f. the sharded prefill and decode steps
             (``make_prefill_step`` / ``make_decode_step`` on a mesh,
             SHARDED_SERVE), f32, TF32 off, an f32 cache: qwen2-1.5b at
             full size, B 8, a prompt of 256 and 3 decode steps, on (2, 2)
             and (1, 4), and recurrentgemma-2b at full width, 3 layers,
             B 1 on (2, 2) (``seq_shard``: the local-attention caches'
             slots split over "data"; a prompt of 2112 wraps its 2048-slot
             ring), against the unsharded steps on the card: the logits
             and every gathered cache leaf within 1e-4 x max(1, max|x|);
             the prefill's and a decode step's collective counts equal id
             by id to their representative traces'; each call's ms.
             None of the 12 entry points may launch
             (``sharded_launches``, ``sharded_families_launches`` for e
             and ``sharded_serve_launches`` for f, of each ``kernels``
             row); each part's seconds are printed.
6. fgft-directed — ``build_fgft(directed=True)`` on one directed community
             graph (n = 256, g = 2048, n_iter = 1), then analysis, synthesis,
             project and the bank; ``shear_apply``, ``gen_operator_apply``
             and ``gen_filter_bank_apply`` must have launched; relative
             error < 0.05.
7. shapes  — each of the 12 entry points held against its plain version at
             the paths' shapes (every cut; the banks also at F = 33 and
             R = 130, batched at B = 64 and on two matrices, and at B = 1,
             so that both batched and B = 1 banks run with several filter
             groups), then timed.  Each ``[time]`` line prints the launch's
             geometry, the card's own count of resident CTAs per SM
             (cudaOccupancyMaxActiveBlocksPerMultiprocessor; a bank launch
             must keep at least three) and the kernel's device time per
             launch from a torch.profiler trace beside the CUDA-event
             time of the whole call; a chain or operator launch also
             prints its lanes per row, rows per warp and warps per CTA
             (launcher.operator_geometry).  The banks' stage-extent
             reduction (launcher.stage_extents, both legs) is timed on its
             own.  After [main-bf16] the same checks and timings for the
             12 bf16 forms on the same tables cast to bf16 (the bound
             counts a value at 2 bytes).  After [main-bf16x] the timings
             of the 24 bf16-signal forms (the 12 entry points on f32 and
             on bf16 tables) on the same tables and signals cast to bf16,
             each timed call held bitwise to its plain version (phase 2
             and [main-bf16x] held them at every cut); the library
             yardstick in bf16, the bound with x and y at 2 bytes and the
             operations at the card's bf16 rate.
8. turns   — only with ``--baseline DIR ...`` (each DIR a checkout of this
             repository, e.g. a ``git archive`` of an earlier commit): the
             four operator and the four chain entry points of this
             checkout and of each DIR timed in turns (this, DIR..., then
             the same in reverse), each tree in a process of its own with
             its own kernel build, on the tables, signals and spectra of
             phase 7's timings, saved by this run (the batched G chain on
             the tier refit's identity block); CUDA-event and profiler
             device ms per call.

Tolerance of the kernel-vs-plain checks: for the G kernels on an f32
signal max|dy| <= 1e-4 * max(1, max|y|), since they and their plain
versions round their FMA contractions differently across about 2S stages;
for the T kernels and for every bf16-signal form max|dy| == 0, since they
round every entry as their plain versions do (no FMA contraction; on a
bf16 signal every product and sum rounded to bf16).

Output: progress lines, a {"kernels": [...]} line (48 rows: each entry
point's four forms, f32 or bf16 tables (``precision``) by f32 or bf16
signal (``signal``); launches per path: ``launches`` on the batched or
single-graph path, on [main-bf16] for a bf16-table form and on
[main-bf16x] for a bf16-signal form, ``ragged_launches``,
``dynamic_launches``, ``async_launches``, ``core_launches``,
``lm_launches``, ``lm_families_launches``, ``train_launches``,
``placed_launches``, ``dryrun_launches``, ``sharded_launches``,
``sharded_families_launches``, ``sharded_serve_launches``), the card's
name and power limit, and as the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import io
import json
import os
import pathlib
import statistics
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16, dense
TOL = 1e-4
DEVICE = "cuda"
#: the main paths' fleet; ``single_g``: g of the single-graph build_fgft
#: paths (phases 4 and 6), n log2 n, half the fleet's 2 n log2 n, for the
#: run's time limit
MAIN = dict(graphs=64, n=256, signals=256, steps=5,
            tiers="full:1.0,balanced:0.5,draft:0.25",
            filters="heat,tikhonov,wavelets:4", single_g=2048,
            directed_n_iter=1)
#: the heterogeneous fleet of [main-ragged]: sizes cycled over the graphs,
#: the largest bucket at the main path's width and a quarter of its g (its
#: fits took 146.6 s of a 1131.5 s run at 4096 on a slow host, 82.2 s of
#: 1169.3 s at 2048); the directed check's small fleet
RAGGED = dict(graphs=64, sizes="64,100,180,256", transforms=1024,
              buckets={64: 16, 128: 16, 256: 32},
              g={64: 192, 128: 448, 256: 1024},
              directed_sizes="12,20,32", directed_graphs=6)
#: the evolving fleet of [main-dynamic]: the main path's fleet under the
#: CLI's update rounds, then forced rounds at 10x the churn, a small fleet
#: for the REFIT, and the directed EXTEND's component budget
DYNAMIC = dict(graphs=64, n=256, transforms=4096, signals=256, rounds=4,
               churn=0.002, forced_churn=0.02, small=dict(graphs=4, n=32),
               directed_extend_fraction=0.03125)
REPLACES = {
    "batched_sym_operator_apply": "src/repro/kernels/butterfly.py:169",
    "batched_butterfly_apply": "src/repro/kernels/butterfly.py:209",
    "sym_operator_apply": "src/repro/kernels/butterfly.py:240",
    "butterfly_apply": "src/repro/kernels/butterfly.py:102",
    "shear_apply": "src/repro/kernels/shear.py:84",
    "gen_operator_apply": "src/repro/kernels/shear.py:115",
    "batched_shear_apply": "src/repro/kernels/shear.py:153",
    "batched_gen_operator_apply": "src/repro/kernels/shear.py:207",
    "sym_filter_bank_apply": "src/repro/kernels/spectral.py:122",
    "gen_filter_bank_apply": "src/repro/kernels/spectral.py:122",
    "batched_sym_filter_bank_apply": "src/repro/kernels/spectral.py:142",
    "batched_gen_filter_bank_apply": "src/repro/kernels/spectral.py:142",
}
#: per real table entry of each kind: bytes the function reads (the indices
#: and values it needs) and flops per signal row — a G pair (i, j, c, s,
#: sigma) 20 B and 6 flops (paper Table 1), a T shear y_i = x_i + beta x_j
#: (i, j, beta) 12 B and 2 flops, a T scaling y_i = alpha x_i (i, alpha) 8 B
#: and 1 flop; with bf16 values each value is 2 B (pair 14 B, shear 10 B,
#: scaling 6 B)
ENTRY_COST = {"pair": (20, 6), "shear": (12, 2), "scaling": (8, 1)}
ENTRY_COST_BF16 = {"pair": (14, 6), "shear": (10, 2), "scaling": (6, 1)}
#: form name of a bf16 check -> the largest max|dy| of the bf16 form
#: against its own f32 form run on the widened tables (printed)
BF16_VS_F32: dict = {}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# comparisons and timing
# ---------------------------------------------------------------------------

def max_err(got, want) -> tuple:
    import torch
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = max(1.0, float(want.abs().max()) if want.numel() else 0.0)
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    return err, scale


def tolerance(entry: str) -> float:
    """Relative kernel-vs-plain tolerance of an entry point form: 0
    (bitwise) for the T kernels and for every bf16-signal form, TOL for
    the G kernels on an f32 signal (module docstring)."""
    from repro_torch.kernels import launcher
    kernel = launcher.KERNEL_OF[entry]
    return 0.0 if kernel.startswith("t_") or "_xbf16_" in kernel else TOL


def compare(name, got, want, errs) -> None:
    err, scale = max_err(got, want)
    tol = tolerance(name)
    check(err <= tol * scale,
          f"{name}: max|dy| {err:.3e} > {tol} * {scale:.3e}")
    errs[name] = max(errs.get(name, 0.0), err)


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over rounds of the mean time of ``reps`` calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, kernel: str, reps: int = 10, traces: int = 3):
    """Device time per launch of ``kernel`` over ``reps`` calls of fn, from
    torch.profiler's CUDA trace (the kernel alone, without the host's
    launch path).  A trace now and then holds none of the launches, so up
    to ``traces`` are taken; None when none of them holds one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        count = sum(e.count for e in events)
        if count:
            total = sum(getattr(e, "device_time_total", None)
                        or getattr(e, "cuda_time_total", 0.0)
                        for e in events)
            return total / 1e3 / count
    return None


def real_entries(staged, num_stages, keep) -> dict:
    """Real (non-pad) entries a leg holds at a cut, over the batch, by
    kind: G pairs, or T shears (j != i) and scalings (j == i)."""
    from repro_torch.core.staging import StagedT
    s_tot = staged.idx_i.shape[-2]
    k = s_tot if num_stages is None else num_stages
    sl = slice(0, k) if keep == "head" else slice(s_tot - k, s_tot)
    ii, jj = staged.idx_i[..., sl, :], staged.idx_j[..., sl, :]
    real = ii < staged.n
    if not isinstance(staged, StagedT):
        return {"pair": int(real.sum())}
    return {"shear": int((real & (jj != ii)).sum()),
            "scaling": int((real & (jj == ii)).sum())}


def bound_ms(x, legs, filters: int, precision: str = "f32") -> tuple:
    """Least time on the card for the function itself.  ``filters``: 0
    for a chain (one leg, no diagonal), 1 for an operator, F for a bank.
    x is read once and y written max(1, F) times; each leg's real entries
    are read once at their kind's ENTRY_COST bytes; the analysis leg
    (legs[0]) costs its ENTRY_COST flops per signal row once, the
    synthesis leg (legs[1]) once per filter; the F diagonals (B F n
    values) are read once and cost n flops per row and filter.  Pad
    entries of the (S, P) layout are not counted: the function does not
    need them, the layout is the kernel's choice.  ``precision`` "bf16"
    counts the values at 2 bytes (ENTRY_COST_BF16).  x and y count at
    x's element size; the operations of a bf16 signal (bf16 in, bf16
    out) at the card's bf16 peak.  Returns (ms, "bytes" |
    "operations")."""
    import torch
    cost = ENTRY_COST if precision == "f32" else ENTRY_COST_BF16
    bsz, rows, n = (1,) * (3 - x.dim()) + tuple(x.shape)
    outputs = max(filters, 1)
    nbytes = ((1 + outputs) * x.numel() * x.element_size()
              + filters * bsz * n * 4)
    flops = filters * bsz * rows * n
    for pos, leg in enumerate(legs):
        runs = outputs if pos > 0 else 1
        for kind, count in leg.items():
            per_bytes, per_flops = cost[kind]
            nbytes += count * per_bytes
            flops += runs * per_flops * count * rows
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rate = (BF16_FLOPS_PER_S if x.dtype != torch.float32
            else F32_FLOPS_PER_S)
    t_ops = flops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def ptxas_report(nvcc: str) -> dict:
    """Registers, stack frame and spill bytes of every kernel, from
    ``nvcc -Xptxas -v`` on each source (one process per source, all
    started together): {kernel: (registers, stack, spill stores, spill
    loads)}."""
    import re
    from repro_torch.kernels import build
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v",
                               "-c", "-o", "/dev/null", str(src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src in build.sources()]
    out, kernel, frame = {}, None, (0, 0, 0)
    for proc in procs:
        text = proc.communicate(timeout=600)[0]
        check(proc.returncode == 0, f"nvcc -Xptxas -v failed:\n{text}")
        for line in text.splitlines():
            m = re.search(r"Compiling entry function .*?([gt]_(?:chain|"
                          r"operator|bank)(?:_x?bf16)?_kernel)", line)
            if m:
                kernel = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                frame = tuple(int(v) for v in m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                out[kernel] = (int(m.group(1)), *frame)
    return out


def sass_fma(nvcc: str) -> dict:
    """{kernel: FFMA instructions} of every bf16-signal kernel in the
    built library, from ``cuobjdump -sass``: these must round each product
    and sum on its own, so one contracted FFMA would break their bitwise
    equality with the plain versions."""
    import re
    from repro_torch.kernels import build
    lib = build.build_dir() / f"librepro_torch_kernels_{build._digest()}.so"
    out = subprocess.run([str(pathlib.Path(nvcc).parent / "cuobjdump"),
                          "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass failed: {out.stderr}")
    counts, kernel = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : \S*?([gt]_(?:chain|operator|bank)"
                      r"(?:_x?bf16)?_kernel)", line)
        if m:
            kernel = m.group(1)
            counts.setdefault(kernel, 0)
        elif kernel and re.search(r"\bFFMA\b", line):
            counts[kernel] += 1
    return counts


def phase_build() -> None:
    from repro_torch.kernels import build, launcher
    nvcc = build.find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    log(f"[build] {nvcc}: {version.splitlines()[-1] if version else '?'}")
    t0 = time.perf_counter()
    build.library()
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f}s")
    for kernel, (regs, stack, st, ld) in sorted(ptxas_report(nvcc).items()):
        log(f"[build] ptxas: {kernel} {regs} registers, {stack} B stack "
            f"frame, spill stores {st} B, spill loads {ld} B")
    fma = sass_fma(nvcc)
    log(f"[build] SASS FFMA count per kernel: {fma}")
    for kernel in launcher.KERNELS:
        check(kernel in fma, f"{kernel} not found in the library's SASS")
        check("_xbf16_" not in kernel or fma[kernel] == 0,
              f"{kernel}: {fma[kernel]} FFMA in its SASS (the bf16-signal "
              f"forms must not contract)")


def lowpass(lam):
    """The low-pass response 1 / (1 + lambda) of the smoke run's filters."""
    return 1.0 / (1.0 + lam)


def cut_list(staged) -> list:
    return sorted({0, *staged.cuts[:, 0].tolist()})


def widened(staged):
    """The f32 tables a bf16 table set widens to (exact), or None for
    f32 tables."""
    from repro_torch.core.staging import table_precision, with_precision
    return (None if table_precision(staged) == "f32"
            else with_precision(staged, "f32"))


def compare_form(name, fn, args, plain, errs, wide_args=None) -> None:
    """``fn(*args)`` against ``plain(*args)`` (``compare``); for a bf16
    form also against ``fn(*wide_args)``, its f32 form on the widened
    tables, into BF16_VS_F32 (an exact widening: 0 unless the two forms
    round differently).  On a bf16 signal both table forms walk the same
    bf16 values (f32 tables are cast by RNE, an exact round trip of the
    widened ones), so there the two must be equal."""
    y = fn(*args)
    compare(name, y, plain(*args), errs)
    if wide_args is not None:
        d = float((y - fn(*wide_args)).abs().max()) if y.numel() else 0.0
        BF16_VS_F32[name] = max(BF16_VS_F32.get(name, 0.0), d)
        check(d == 0.0 or "_xbf16" not in name,
              f"{name}: bf16 tables != their widened f32 tables on a bf16 "
              f"signal, max|dy| {d:.3e}")


def forms_note(*names) -> str:
    """The printed bf16-vs-f32 deltas of the named forms, if any."""
    got = {k: BF16_VS_F32[k] for k in names if k in BF16_VS_F32}
    return ("" if not got else "; bf16 form vs its f32 form on the "
            "widened tables max|dy| " + ", ".join(
                f"{k} {v:.3e}" for k, v in got.items()))


def check_tables(tag, fwd, adj, diag, x, errs) -> int:
    """Both kernels (batched if the tables are) against the plain
    versions at every cut (bf16 tables: the bf16 forms, also against
    their f32 forms on the widened tables); returns the number of
    comparisons."""
    from repro_torch.core.staging import table_precision
    from repro_torch.kernels import butterfly as bf
    from repro_torch.kernels import launcher, ref
    batched = fwd.idx_i.dim() == 3
    prec = table_precision(fwd)
    wfwd, wadj = widened(fwd), widened(adj)
    chain = bf.batched_butterfly_apply if batched else bf.butterfly_apply
    chain_ref = ref.batched_g_apply if batched else ref.staged_g_apply
    op = (bf.batched_sym_operator_apply if batched
          else bf.sym_operator_apply)
    op_ref = (ref.batched_sym_operator_apply if batched
              else ref.sym_operator_apply)
    sig = launcher.signal_precision(x)
    chain_name = launcher.form("batched_butterfly_apply" if batched
                               else "butterfly_apply", prec, sig)
    op_name = launcher.form("batched_sym_operator_apply" if batched
                            else "sym_operator_apply", prec, sig)
    count = 0
    for k in cut_list(fwd):
        for staged, wide, keep in ((fwd, wfwd, "tail"), (adj, wadj, "head"),
                                   (fwd, wfwd, "head"), (adj, wadj, "tail")):
            compare_form(chain_name, chain, (staged, x, k, keep), chain_ref,
                         errs, wide and (wide, x, k, keep))
            count += 1
        compare_form(op_name, op, (fwd, adj, diag, x, k), op_ref, errs,
                     wfwd and (wfwd, wadj, diag, x, k))
        count += 1
    log(f"[kernels] {tag}: {count} kernel-vs-plain checks at cuts "
        f"{cut_list(fwd)} passed ({prec} tables, {sig} signal)"
        + forms_note(chain_name, op_name))
    return count


def tables_for(basis, b: int):
    """B = 1 tables of matrix b of a batched basis (packed by the port)."""
    from repro_torch.core.staging import pack_g_pair
    from repro_torch.core.types import GFactors
    f = GFactors(*(t[b] for t in basis.factors))
    return pack_g_pair(f, n=basis.n, device=basis.device)


def check_t_tables(tag, fwd, inv, diag, x, errs) -> int:
    """Both T kernels (batched if the tables are) against the plain
    versions at every cut, the chain on both table sets at both keeps
    (bf16 tables: as check_tables); returns the number of
    comparisons."""
    from repro_torch.core.staging import table_precision
    from repro_torch.kernels import launcher, ref
    from repro_torch.kernels import shear as sh
    batched = fwd.idx_i.dim() == 3
    prec = table_precision(fwd)
    wfwd, winv = widened(fwd), widened(inv)
    chain = sh.batched_shear_apply if batched else sh.shear_apply
    chain_ref = ref.batched_t_apply if batched else ref.staged_t_apply
    op = sh.batched_gen_operator_apply if batched else sh.gen_operator_apply
    op_ref = (ref.batched_gen_operator_apply if batched
              else ref.gen_operator_apply)
    sig = launcher.signal_precision(x)
    chain_name = launcher.form("batched_shear_apply" if batched
                               else "shear_apply", prec, sig)
    op_name = launcher.form("batched_gen_operator_apply" if batched
                            else "gen_operator_apply", prec, sig)
    count = 0
    for k in cut_list(fwd):
        for staged, wide in ((fwd, wfwd), (inv, winv)):
            for keep in ("head", "tail"):
                compare_form(chain_name, chain, (staged, x, k, keep),
                             chain_ref, errs, wide and (wide, x, k, keep))
                count += 1
        compare_form(op_name, op, (fwd, inv, diag, x, k), op_ref, errs,
                     wfwd and (wfwd, winv, diag, x, k))
        count += 1
    log(f"[kernels] {tag}: {count} T kernel-vs-plain checks at cuts "
        f"{cut_list(fwd)} passed ({prec} tables, {sig} signal)"
        + forms_note(chain_name, op_name))
    return count


def t_tables_for(basis, b: int):
    """B = 1 T tables of matrix b of a batched general basis."""
    from repro_torch.core.staging import pack_t_pair
    from repro_torch.core.types import TFactors
    f = TFactors(*(t[b] for t in basis.factors))
    return pack_t_pair(f, basis.n, device=basis.device)


def bank_gains(spectrum):
    """(F, n) gains of the smoke run's bank on a single graph's spectrum
    (n,)."""
    import torch
    from repro_torch.spectral import named_responses
    return torch.stack([h(spectrum) for h in
                        named_responses(MAIN["filters"]).values()])


def bank_groups(entry, fwd, x, filters: int) -> int:
    """Filter groups per row tile of a bank launch at these shapes."""
    from repro_torch.kernels import launcher
    bsz, rows, n = (1,) * (3 - x.dim()) + tuple(x.shape)
    geo = launcher.launch_geometry(entry, bsz, rows, n, filters,
                                   int(fwd.idx_i.shape[-1]))
    return -(-filters // geo["filters_per_cta"])


def check_bank_tables(tag, fwd, bwd, gains, x, errs,
                      filter_counts=None) -> dict:
    """The bank kernel of the tables' family (batched if they are)
    against its plain version at every cut, with the first filter and
    with all of ``gains``' filters (or the leading ``filter_counts``;
    bf16 tables: as check_tables); returns {F: filter groups of its
    launches}."""
    from repro_torch.core.staging import StagedT, table_precision
    from repro_torch.kernels import launcher, ref
    from repro_torch.kernels import spectral as ksp
    entry = (("batched_" if fwd.idx_i.dim() == 3 else "")
             + ("gen" if isinstance(fwd, StagedT) else "sym")
             + "_filter_bank_apply")
    fn, plain = getattr(ksp, entry), getattr(ref, entry)
    sig = launcher.signal_precision(x)
    name = launcher.form(entry, table_precision(fwd), sig)
    wfwd, wbwd = widened(fwd), widened(bwd)
    counts = sorted(filter_counts or {1, gains.shape[-2]})
    count = 0
    for k in cut_list(fwd):
        for f in counts:
            g = gains[..., :f, :].contiguous()
            compare_form(name, fn, (fwd, bwd, g, x, k), plain, errs,
                         wfwd and (wfwd, wbwd, g, x, k))
            count += 1
    groups = {f: bank_groups(name, fwd, x, f) for f in counts}
    log(f"[kernels] {tag}: {count} {name} kernel-vs-plain checks at cuts "
        f"{cut_list(fwd)}, F in {counts} (filter groups {groups}) passed "
        f"({sig} signal)" + forms_note(name))
    return groups


def directed_laps(n: int, count: int):
    import numpy as np
    from repro_torch.core import laplacian
    from repro_torch.graphs import community_graph, directed_variant
    return np.stack([laplacian(directed_variant(community_graph(n, seed=s),
                                                seed=s))
                     for s in range(count)])


def random_tables(family: str, n: int, batch: int, g: int, seed: int):
    """(fwd, bwd) tables of ``batch`` random chains of g components."""
    import numpy as np
    from repro_torch.core import staging
    from repro_torch.core.types import GFactors, TFactors
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, (batch, g))
    j = (i + rng.integers(1, n, (batch, g))) % n
    if family == "sym":
        theta = rng.uniform(-np.pi, np.pi, (batch, g))
        f = GFactors(np.minimum(i, j).astype(np.int32),
                     np.maximum(i, j).astype(np.int32),
                     np.cos(theta).astype(np.float32),
                     np.sin(theta).astype(np.float32),
                     rng.choice([-1.0, 1.0], (batch, g)).astype(np.float32))
        return staging.pack_g_batch_pair(f, n, device=DEVICE)
    kind = rng.integers(0, 2, (batch, g)).astype(np.int32)
    scale = (rng.uniform(0.8, 1.25, (batch, g))
             * rng.choice([-1.0, 1.0], (batch, g)))
    a = np.where(kind == 0, scale, rng.uniform(-0.5, 0.5, (batch, g)))
    f = TFactors(kind, i.astype(np.int32),
                 np.where(kind == 0, i, j).astype(np.int32),
                 a.astype(np.float32))
    return staging.pack_t_batch_pair(f, n, device=DEVICE)


def check_split(precision: str = "f32", signal: str = "f32") -> None:
    """A batch of 7 at a grid limit forced down to 3 matrices: each
    family's chain, operator and bank entry point (its form at the table
    ``precision`` and the ``signal`` precision) launches three times (on
    [0, 3), [3, 6) and [6, 7)) and equals its unsplit launch bitwise."""
    import torch
    from repro_torch.core.staging import PRECISION_DTYPE, with_precision
    from repro_torch.kernels import launcher
    from repro_torch.kernels import spectral as ksp
    from repro_torch.kernels import butterfly as bf
    from repro_torch.kernels import shear as sh
    n, batch = 48, 7
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    x = torch.randn((batch, 130, n), generator=gen, device=DEVICE).to(
        PRECISION_DTYPE[signal])
    diag = torch.rand((batch, n), generator=gen, device=DEVICE) * n
    gains = torch.rand((batch, 5, n), generator=gen, device=DEVICE) * 2.0
    for family, mod, names in (
            ("sym", bf, ("batched_butterfly_apply",
                         "batched_sym_operator_apply",
                         "batched_sym_filter_bank_apply")),
            ("general", sh, ("batched_shear_apply",
                             "batched_gen_operator_apply",
                             "batched_gen_filter_bank_apply"))):
        fwd, bwd = (with_precision(t, precision)
                    for t in random_tables(family, n, batch, 200, 5))
        k = int(fwd.cuts[1, 0])
        chain, op = getattr(mod, names[0]), getattr(mod, names[1])
        bank = getattr(ksp, names[2])
        calls = (lambda: chain(fwd, x, k, "tail"),
                 lambda: op(fwd, bwd, diag, x, k),
                 lambda: bank(fwd, bwd, gains, x, k))
        whole = [call() for call in calls]
        grid = launcher._GRID_B
        launcher._GRID_B = 3
        try:
            launcher.reset_launch_counts()
            split = [call() for call in calls]
            counts = launcher.entry_launch_counts()
        finally:
            launcher._GRID_B = grid
        for name, got, want in zip(names, split, whole):
            name = launcher.form(name, precision, signal)
            check(got.dtype == x.dtype, f"{name}: y is {got.dtype}")
            check(torch.equal(got, want),
                  f"{name}: split launch != unsplit launch")
            check(counts[name] == 3,
                  f"{name}: {counts[name]} launches for 3 slices")
    torch.cuda.synchronize()
    log(f"[kernels] batch split ({precision} tables, {signal} signal): "
        f"B={batch} at a grid limit of 3 matrices, chain, operator and "
        f"bank of both families: 3 launches each, bitwise equal to the "
        f"unsplit launches")


def phase_kernels(errs) -> None:
    """Phase 2: every entry point form against its plain version (module
    docstring), on f32 and bf16 signals."""
    import numpy as np
    import torch
    from repro_torch.core import ApproxEigenbasis, laplacian
    from repro_torch.graphs import community_graph
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    for n in (16, 48):
        g = int(2 * n * np.log2(n))
        laps = np.stack([laplacian(community_graph(n, seed=s))
                         for s in range(4)])
        basis = ApproxEigenbasis.fit(laps, g, n_iter=1, device=dev)
        gen = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn((4, 130, n), generator=gen, device=dev)
        gains = torch.rand((4, 33, n), generator=gen, device=dev) * 2.0
        x1, g1 = x[1].contiguous(), gains[1].contiguous()
        tbasis = ApproxEigenbasis.fit(directed_laps(n, 4), g, n_iter=1,
                                      kind="general", device=dev)
        # per family: (check, batched tables, B = 1 tables, spectra)
        families = (
            (check_tables, (basis.fwd, basis.bwd), tables_for(basis, 1),
             basis.spectrum),
            (check_t_tables, (tbasis.fwd, tbasis.bwd),
             t_tables_for(tbasis, 1), tbasis.spectrum))
        # f32 signals, then bf16 signals (the bf16-signal forms); each on
        # the fits' tables and on the same tables cast to bf16
        for dtype in (torch.float32, torch.bfloat16):
            xs, x1s = x.to(dtype), x1.to(dtype)
            for precision in ("f32", "bf16"):
                for check_fn, tabs, tabs1, spec in families:
                    fwd, bwd = at_precision(precision, *tabs)
                    sfwd, sbwd = at_precision(precision, *tabs1)
                    check_fn(f"n={n} B=4 R=130", fwd, bwd, spec, xs, errs)
                    check_bank_tables(f"n={n} B=4 R=130", fwd, bwd, gains,
                                      xs, errs, (1, 7, 33))
                    check_fn(f"n={n} B=1 R=130", sfwd, sbwd, spec[1], x1s,
                             errs)
                    check_bank_tables(f"n={n} B=1 R=130", sfwd, sbwd, g1,
                                      x1s, errs, (1, 7, 33))
    for signal in ("f32", "bf16"):
        for precision in ("f32", "bf16"):
            check_split(precision, signal)
    torch.cuda.synchronize()
    log(f"[kernels] phase 2: {time.perf_counter() - t0:.1f}s in all")


def phase_main() -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch import serve
    argv = ["--fgft", "--graphs", str(MAIN["graphs"]),
            "--graph-n", str(MAIN["n"]), "--signals", str(MAIN["signals"]),
            "--filter-steps", str(MAIN["steps"]), "--tiers", MAIN["tiers"],
            "--device", DEVICE]
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launcher.entry_launch_counts()
    log(f"[main] serve --fgft {' '.join(argv[1:])}: {wall:.1f}s "
        f"(fit {out['fit_s']:.1f}s); launches {launches}")
    for entry in ("batched_sym_operator_apply", "batched_butterfly_apply"):
        check(launches[entry] > 0, f"main path never launched {entry}")
    engine, laps = out["engine"], out["laps"]
    basis = engine.basis
    n = basis.n
    dense = dense_rel_error(basis, laps)
    rel = np.asarray(out["rel_error"], np.float64)
    mean_rel, mean_dense = float(rel.mean()), float(dense.mean())
    log(f"[main] full-tier relative error: mean {mean_rel:.6f} from the "
        f"fit objective, {mean_dense:.6f} recomputed densely")
    check(bool(np.isfinite(rel).all()), "non-finite relative error")
    check(mean_rel < 0.05, f"mean relative error {mean_rel} >= 0.05")
    check(abs(mean_dense - mean_rel) <= 1e-3 * mean_rel,
          f"dense relative error {mean_dense} != objective {mean_rel}")
    for name, ts in out["tiers"].items():
        log(f"[main] tier {name}: {ts['transforms_per_s']:.1f} "
            f"graph-transforms/s, {ts['num_transforms']} components, "
            f"{ts['num_stages']} stages")
    x = out["signals"]
    y = engine.step(x, lowpass, tier="full")
    plain = ApplyPlan(family="sym", mode="operator", n=n, batched=True,
                      backend="torch", device=DEVICE).program()
    spec = engine.tiers["full"]["spectrum"]
    y_ref = plain(engine._live.fwd, engine._live.bwd, lowpass(spec), x)
    check(tuple(y.shape) == tuple(x.shape), f"served shape {tuple(y.shape)}")
    err, scale = max_err(y, y_ref)
    check(err <= TOL * scale, f"served full tier max|dy| {err:.3e}")
    log(f"[main] served full tier vs plain version: max|dy| {err:.3e} "
        f"(scale {scale:.3e})")
    torch.cuda.synchronize()
    return {"out": out, "launches": launches, "wall_s": wall,
            "mean_rel": mean_rel, "mean_rel_dense": mean_dense,
            "served_err": err}


def check_bank_slices(tag, engine, yb, x, tol: float) -> float:
    """Each filter of a served bank (B, F, R, n) against ``engine.step``
    with that filter's response at the full tier (the operator kernel);
    returns the largest max|dy|."""
    worst = 0.0
    for f, filt in enumerate(engine.bank.filters):
        err, scale = max_err(yb[:, f], engine.step(x, filt.response))
        check(err <= tol * scale,
              f"{tag}: filter {filt.name} vs operator max|dy| {err:.3e}")
        worst = max(worst, err)
    log(f"[{tag}] each of {len(engine.bank)} filters vs the operator kernel "
        f"with its gains: max|dy| {worst:.3e} (tolerance {tol} * scale)")
    return worst


def phase_main_filter(errs) -> dict:
    """The filter-bank path through the CLI: ``serve --fgft --filter``."""
    import numpy as np
    import torch
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch import serve
    argv = ["--fgft", "--filter", MAIN["filters"], "--graphs",
            str(MAIN["graphs"]), "--graph-n", str(MAIN["n"]), "--signals",
            str(MAIN["signals"]), "--filter-steps", str(MAIN["steps"]),
            "--device", DEVICE]
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launcher.entry_launch_counts()
    log(f"[main-filter] serve {' '.join(argv)}: {wall:.1f}s (fit "
        f"{out['fit_s']:.1f}s), {out['responses_per_s']:.1f} responses/s; "
        f"launches {launches}")
    check(launches["batched_sym_filter_bank_apply"] > 0,
          "filter-bank path never launched batched_sym_filter_bank_apply")
    engine, x = out["engine"], out["signals"]
    basis, live = engine.basis, engine._live
    bsz, rows, n = x.shape
    nf = len(engine.bank)
    check(out["filters"] == engine.bank.names and nf == 7,
          f"bank filters {out['filters']}")
    y = engine.step_bank(x)
    check(tuple(y.shape) == (bsz, nf, rows, n), f"bank shape {tuple(y.shape)}")
    plain = ApplyPlan(family="sym", mode="bank", n=n, batched=True,
                      backend="torch", device=DEVICE).program()
    err, scale = max_err(y, plain(live.fwd, live.bwd, live.bank_gains, x))
    check(err <= TOL * scale, f"served bank max|dy| {err:.3e}")
    errs["batched_sym_filter_bank_apply"] = max(
        errs.get("batched_sym_filter_bank_apply", 0.0), err)
    log(f"[main-filter] served bank {list(y.shape)} vs plain version: "
        f"max|dy| {err:.3e} (scale {scale:.3e})")
    check_bank_slices("main-filter", engine, y, x, TOL)
    worst = check_filters_dense("main-filter", engine, y, x, out["laps"],
                                out["rel_error"])
    return {"out": out, "launches": launches, "wall_s": wall,
            "worst_ratio": worst}


def check_filters_dense(tag, engine, y, x, laps, rel_error) -> float:
    """Each filter of a served bank y (B, F, R, n) against dense ``eigh``
    filtering of x, per graph, within the accuracy the fit's error
    implies: 2 max(Lip(h), 1) delta + 5e-3, delta = sqrt(relative error)
    (tests/test_spectral.py's bound).  Returns the worst error/bound."""
    import numpy as np
    import torch
    from repro_torch.spectral import response_lipschitz
    lap = torch.from_numpy(laps).to(DEVICE, torch.float64)
    lam, u = torch.linalg.eigh(lap)
    delta = np.sqrt(np.asarray(rel_error, np.float64))
    xd = x.double()
    worst = 0.0
    for f, filt in enumerate(engine.bank.filters):
        hd = filt.response(lam.float()).double()
        dense = xd @ (u * hd[:, None, :]) @ u.transpose(1, 2)
        err_b = (torch.linalg.norm(y[:, f].double() - dense, dim=(1, 2))
                 / torch.linalg.norm(dense, dim=(1, 2)).clamp(min=1e-12)
                 ).cpu().numpy()
        lip = max(response_lipschitz(filt.response), 1.0)
        bound = 2.0 * lip * delta + 5e-3
        ratio = float((err_b / bound).max())
        log(f"[{tag}] filter {filt.name}: Lip {lip:.3f}, max rel error "
            f"vs dense eigh {float(err_b.max()):.5f}, worst error/bound "
            f"{ratio:.4f}")
        check(bool((err_b <= bound).all()),
              f"{tag}: filter {filt.name} exceeds its dense-eigh bound "
              f"(error/bound {ratio:.3f})")
        worst = max(worst, ratio)
    log(f"[{tag}] worst error/bound over {len(engine.bank)} filters x "
        f"{x.shape[0]} graphs: {worst:.4f} (mean relative error "
        f"{float(delta.mean() ** 2):.6f})")
    torch.cuda.synchronize()
    return worst


def phase_fgft(errs) -> dict:
    """The single-graph entry points at the main path's width."""
    import numpy as np
    import torch
    from repro_torch.core import build_fgft, laplacian, relative_error
    from repro_torch.graphs import community_graph
    from repro_torch.kernels import launcher, ref
    from repro_torch.kernels.plan import ApplyPlan
    n = MAIN["n"]
    g = MAIN["single_g"]
    lap = laplacian(community_graph(n, seed=0))
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    x = torch.randn((MAIN["signals"], n), generator=gen, device=DEVICE)
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    f = build_fgft(lap, g, n_iter=1, device=DEVICE)
    fit_s = time.perf_counter() - t0
    xh = f.analysis(x)
    xr = f.synthesis(xh)
    y = f.project(x, lowpass)
    gains = bank_gains(f.spectrum)
    yb = ApplyPlan(family="sym", mode="bank", n=n, batched=False,
                   device=DEVICE).bank(f.fwd, f.bwd, gains, x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launcher.entry_launch_counts()
    log(f"[single] build_fgft n={n} g={g} + analysis/synthesis/project/bank "
        f"of R={x.shape[0]}: {wall:.1f}s (fit {fit_s:.1f}s); launches "
        f"{launches}")
    for entry in ("sym_operator_apply", "butterfly_apply",
                  "sym_filter_bank_apply"):
        check(launches[entry] > 0, f"single-graph path never launched {entry}")
    rel = relative_error(lap, f)
    log(f"[single] relative error {rel:.6f}, {f.fwd.idx_i.shape[0]} stages "
        f"of {f.fwd.idx_i.shape[1]} pairs")
    check(np.isfinite(rel) and rel < 0.05, f"relative error {rel} >= 0.05")
    compare("butterfly_apply", xh, ref.staged_g_apply(f.bwd, x), errs)
    compare("butterfly_apply", xr, ref.staged_g_apply(f.fwd, xh, None,
                                                      "tail"), errs)
    compare("sym_operator_apply", y, ref.sym_operator_apply(
        f.fwd, f.bwd, lowpass(f.spectrum), x), errs)
    compare("sym_filter_bank_apply", yb, ref.sym_filter_bank_apply(
        f.fwd, f.bwd, gains, x), errs)
    err, scale = max_err(xr, x)
    check(err <= TOL * scale, f"synthesis(analysis(x)) != x: {err:.3e}")
    log(f"[single] synthesis(analysis(x)) vs x: max|dx| {err:.3e}")
    return {"fgft": f, "launches": launches, "signals": x, "gains": gains}


def signal_dtype(signal: str):
    """The torch dtype of a signal precision ("f32" or "bf16")."""
    from repro_torch.core.staging import PRECISION_DTYPE
    return PRECISION_DTYPE[signal]


def at_precision(precision: str, *tables) -> list:
    """The table sets at a storage precision (with_precision)."""
    from repro_torch.core.staging import with_precision
    return [with_precision(t, precision) for t in tables]


def phase_main_shapes(main, single, errs, precision: str = "f32",
                      launches=None, signal: str = "f32") -> list:
    """Kernel vs plain at the two paths' shapes, then timings; with
    ``precision`` "bf16" the same on the paths' tables cast to bf16 (the
    bf16 forms, their launches from ``launches``).  With ``signal``
    "bf16" the signals are cast to bf16 (the bf16-signal forms, their
    launches from ``launches``): phase 2 and [main-bf16x] held them at
    every cut and at these shapes, so only the timed calls are held
    (bitwise) to their plain versions here."""
    import torch
    from repro_torch.kernels import butterfly as bf
    from repro_torch.kernels import launcher, ref
    engine = main["out"]["engine"]
    basis = engine.basis
    fwd, bwd = at_precision(precision, basis.fwd, basis.bwd)
    n, bsz = basis.n, basis.spectrum.shape[0]
    dtype = signal_dtype(signal)
    x = main["out"]["signals"].to(dtype)
    eye = torch.eye(n, device=DEVICE).expand(bsz, n, n).contiguous()
    f = single["fgft"]
    sfwd, sadj = at_precision(precision, f.fwd, f.bwd)
    sspec, x0 = f.spectrum, single["signals"].to(dtype)
    if signal == "f32":
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        ragged = torch.randn((bsz, 130, n), generator=gen, device=DEVICE)
        check_tables(f"main n={n} B={bsz} R={x.shape[1]}", fwd, bwd,
                     basis.spectrum, x, errs)
        check_tables(f"main n={n} B={bsz} R=130", fwd, bwd, basis.spectrum,
                     ragged, errs)
        wide = widened(fwd)
        for name in ("balanced", "draft"):
            k = engine.tiers[name]["num_stages"]
            compare_form(launcher.form("batched_butterfly_apply", precision),
                         bf.batched_butterfly_apply, (fwd, eye, k, "tail"),
                         ref.batched_g_apply, errs,
                         wide and (wide, eye, k, "tail"))
        check_tables(f"fgft n={n} B=1 R={x0.shape[0]}", sfwd, sadj, sspec,
                     x0, errs)
    torch.cuda.synchronize()

    # timings at the main path's shapes (full chain); the dense
    # yardsticks in the signal's dtype
    spec = basis.spectrum
    ut = bf.batched_butterfly_apply(fwd, eye)              # rows: Ubar^T
    u = ut.transpose(1, 2).contiguous()
    dense_op = (u @ torch.diag_embed(spec) @ u.transpose(1, 2)).to(dtype)
    su = bf.butterfly_apply(sfwd, torch.eye(n, device=DEVICE)).T.contiguous()
    sdense = (su @ torch.diag(sspec) @ su.T).to(dtype)
    u, su, eye = u.to(dtype), su.to(dtype), eye.to(dtype)
    fwd_legs = [real_entries(fwd, None, "tail")]
    op_legs = [real_entries(bwd, None, "head")] + fwd_legs
    single_fwd = [real_entries(sfwd, None, "tail")]
    single_op = [real_entries(sadj, None, "head")] + single_fwd
    cases = [
        ("g_operator_kernel", "batched_sym_operator_apply", x, op_legs, 1,
         lambda: bf.batched_sym_operator_apply(fwd, bwd, spec, x),
         lambda: ref.batched_sym_operator_apply(fwd, bwd, spec, x),
         lambda: torch.bmm(x, dense_op.transpose(1, 2))),
        ("g_chain_kernel", "batched_butterfly_apply", eye, fwd_legs, 0,
         lambda: bf.batched_butterfly_apply(fwd, eye),
         lambda: ref.batched_g_apply(fwd, eye),
         lambda: torch.bmm(eye, u.transpose(1, 2))),
        ("g_operator_kernel", "sym_operator_apply", x0, single_op, 1,
         lambda: bf.sym_operator_apply(sfwd, sadj, sspec, x0),
         lambda: ref.sym_operator_apply(sfwd, sadj, sspec, x0),
         lambda: torch.mm(x0, sdense.T)),
        ("g_chain_kernel", "butterfly_apply", x0, single_fwd, 0,
         lambda: bf.butterfly_apply(sfwd, x0),
         lambda: ref.staged_g_apply(sfwd, x0),
         lambda: torch.mm(x0, su.T)),
    ]
    return timed_rows(cases, main, single, fwd, sfwd, errs, "sym",
                      precision, launches, signal)


def timed_rows(cases, main, single, tables_b, tables_1, errs,
               family: str, precision: str = "f32", launches=None,
               signal: str = "f32") -> list:
    """Time each case (kernel, plain version, library yardstick) and
    build its row of the ``kernels`` line; batched entries report the
    batched path's launches, B = 1 entries the single-graph path's.  At
    ``precision`` "bf16" each case is the entry point's bf16 form (its
    kernel, form name and bf16 bound), with the launches of
    ``launches`` (the [main-bf16] path's); at ``signal`` "bf16" its
    bf16-signal form (x and y at 2 bytes in the bound), held bitwise to
    its plain version, with [main-bf16x]'s launches."""
    import torch
    source = ("src/repro_torch/csrc/butterfly.cu" if family == "sym"
              else "src/repro_torch/csrc/shear.cu")
    from repro_torch.kernels import launcher
    rows = []
    for kernel, entry, xin, legs, filters, fn, plain, lib in cases:
        base = entry
        entry = launcher.form(entry, precision, signal)
        kernel = launcher.KERNEL_OF[entry]
        if signal != "f32":
            y, want = fn(), plain()
            check(y.dtype == xin.dtype and torch.equal(y, want),
                  f"{entry}: the timed call != its plain version")
        ms = time_ms(fn)
        dev_ms = device_ms(fn, kernel)
        plain_ms = time_ms(plain, reps=1, rounds=3)
        lib_ms = time_ms(lib)
        b_ms, b_by = bound_ms(xin, legs, filters, precision)
        batched = entry.startswith("batched")
        path = main if batched else single
        tables = tables_b if batched else tables_1
        bsz, nrows, n = (1,) * (3 - xin.dim()) + tuple(xin.shape)
        geo = launcher.launch_geometry(entry, bsz, nrows, n, max(filters, 1),
                                       int(tables.idx_i.shape[-1]))
        rows.append({
            "name": kernel if batched else f"{kernel}[B=1]",
            "entry": entry, "route": "cuda", "source": source,
            "replaces": REPLACES[base], "precision": precision,
            "signal": signal,
            "launches": (launches if launches is not None
                         else path["launches"])[entry],
            "max_abs_err": errs[entry], "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": list(xin.shape), "filters": filters,
            "stages": int(tables.idx_i.shape[-2]),
            "pairs_per_stage": int(tables.idx_i.shape[-1]),
            "real_entries": legs,
            "bf16_vs_f32_max_abs": BF16_VS_F32.get(entry), **geo})
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        lanes = (f" ({geo['warps_per_cta']} warps of {geo['rows_per_warp']} "
                 f"rows, {geo['lanes_per_row']} lanes per row)"
                 if "lanes_per_row" in geo else "")
        log(f"[time] {entry} ({kernel}) at {list(xin.shape)}, F={filters}: "
            f"{ms:.4f} ms (device {dev_txt}), plain {plain_ms:.3f} ms, "
            f"library {lib_ms:.4f} ms, "
            f"bound "
            f"{b_ms:.5f} ms ({b_by}), real entries per leg {legs} of "
            f"{tables.idx_i.numel()} table entries; {geo['ctas']} CTAs of "
            f"{geo['rows_per_cta']} rows x {geo['filters_per_cta']} "
            f"filters{lanes}, {geo['resident_per_sm']} resident per SM")
    return rows


def bank_checks(family, fwd, bwd, gains, x, sfwd, sbwd, g0, x0,
                errs) -> None:
    """phase_bank_shapes' kernel-vs-plain checks of the bank at the
    paths' shapes: every cut, F in {1, 7} at the served R, and at a
    ragged R = 130 also F = 33 (the served gains and 26 random filters),
    batched at B = 64 and on the first two matrices, and at B = 1, where
    33 filters need several filter groups."""
    import torch
    from repro_torch.core.staging import table_arrays
    bsz, _, n = x.shape
    gen = torch.Generator(device=DEVICE).manual_seed(19)
    ragged = torch.randn((bsz, 130, n), generator=gen, device=DEVICE)
    for tag, tf, tb, g, xin in (
            (f"B={bsz} R={x.shape[1]}", fwd, bwd, gains, x),
            (f"B=1 R={x0.shape[0]}", sfwd, sbwd, g0, x0)):
        check_bank_tables(f"{family} bank n={n} {tag}", tf, tb, g, xin, errs)
    wide = torch.cat([gains, torch.rand((bsz, 26, n), generator=gen,
                                        device=DEVICE) * 2.0], dim=1)
    wide1 = torch.cat([g0, wide[0, 7:]], dim=0)

    def first_two(staged):
        return type(staged)(*(t[:2].contiguous()
                              for t in table_arrays(staged)),
                            staged.cuts, staged.n)
    for tag, tf, tb, g, xin, split in (
            (f"B={bsz} R=130", fwd, bwd, wide, ragged, False),
            ("B=2 R=130", first_two(fwd), first_two(bwd), wide[:2],
             ragged[:2].contiguous(), True),
            ("B=1 R=130", sfwd, sbwd, wide1, x0[:130].contiguous(), True)):
        groups = check_bank_tables(f"{family} bank n={n} {tag}", tf, tb, g,
                                   xin, errs, (1, 7, 33))
        check(not split or groups[33] > 1,
              f"{family} bank {tag}: F = 33 ran in one filter group")


def phase_bank_shapes(family: str, path: dict, engine, x, single,
                      errs, precision: str = "f32", launches=None,
                      signal: str = "f32") -> list:
    """The family's bank kernel against its plain version at the paths'
    shapes (every cut, F in {1, 7}; the served R and a ragged R = 130,
    there also F = 33: the served gains and 26 random filters, batched
    at B = 64 and on the first two matrices, and at B = 1, where 33
    filters need several filter groups), then timed: batched on the
    served engine's tables and gains, B = 1 on the single-graph fit's,
    and the stage-extent reduction of both legs on its own.  The library
    yardstick is one ``torch.matmul`` over dense per-filter operators
    built outside the timing (from the kernel's own output on the
    identity).  ``precision``, ``launches`` and ``signal``: as in
    phase_main_shapes."""
    import torch
    from repro_torch.kernels import launcher, ref
    from repro_torch.kernels import spectral as ksp
    from repro_torch.kernels.launcher import leg_orientation
    basis, gains = engine.basis, engine._live.bank_gains
    fwd, bwd = at_precision(precision, basis.fwd, basis.bwd)
    dtype = signal_dtype(signal)
    x = x.to(dtype)
    bsz, rows, n = x.shape
    f = single["fgft"]
    sfwd, sbwd = at_precision(precision, f.fwd, f.bwd)
    x0, g0 = single["signals"].to(dtype), single["gains"]
    if signal == "f32":
        bank_checks(family, fwd, bwd, gains, x, sfwd, sbwd, g0, x0, errs)
    torch.cuda.synchronize()
    ext_ms = time_ms(lambda: (launcher.stage_extents(bwd),
                              launcher.stage_extents(fwd)))
    ext_ms1 = time_ms(lambda: (launcher.stage_extents(sbwd),
                               launcher.stage_extents(sfwd)))
    log(f"[time] {family} bank stage extents of both legs: {ext_ms:.4f} ms "
        f"at {list(fwd.idx_i.shape)} x 2, {ext_ms1:.4f} ms at "
        f"{list(sfwd.idx_i.shape)} x 2")

    entry = ("sym" if family == "sym" else "gen") + "_filter_bank_apply"
    bank, bank1 = getattr(ksp, "batched_" + entry), getattr(ksp, entry)
    plain, plain1 = getattr(ref, "batched_" + entry), getattr(ref, entry)
    eye = torch.eye(n, device=DEVICE)
    # row r of a bank's output on the identity is op e_r: transposed, the
    # dense (B, F, n, n) / (F, n, n) operators
    ops = bank(fwd, bwd, gains, eye.expand(bsz, n, n).contiguous()
               ).transpose(-1, -2).contiguous().to(dtype)
    ops1 = bank1(sfwd, sbwd, g0, eye).transpose(-1, -2).contiguous().to(
        dtype)
    a_keep, s_keep = leg_orientation(family)
    legs = [real_entries(bwd, None, a_keep), real_entries(fwd, None, s_keep)]
    legs1 = [real_entries(sbwd, None, a_keep),
             real_entries(sfwd, None, s_keep)]
    kernel = "g_bank_kernel" if family == "sym" else "t_bank_kernel"
    cases = [
        (kernel, "batched_" + entry, x, legs, gains.shape[1],
         lambda: bank(fwd, bwd, gains, x),
         lambda: plain(fwd, bwd, gains, x),
         lambda: torch.matmul(x.unsqueeze(1), ops.transpose(-1, -2))),
        (kernel, entry, x0, legs1, g0.shape[0],
         lambda: bank1(sfwd, sbwd, g0, x0),
         lambda: plain1(sfwd, sbwd, g0, x0),
         lambda: torch.matmul(x0.unsqueeze(0), ops1.transpose(-1, -2))),
    ]
    out = timed_rows(cases, path, single, fwd, sfwd, errs, family,
                     precision, launches, signal)
    for row, ms in zip(out, (ext_ms, ext_ms1)):
        row["extent_ms"] = ms
        check(row["resident_per_sm"] >= 3,
              f"{row['name']}: {row['resident_per_sm']} resident CTAs per SM")
    return out


def check_round_trip(tag, xr, x, t_dense, num_stages: int) -> float:
    """synthesis(analysis(x)) == x for a T basis.  Tbar is not
    orthogonal: the round trip is exact only up to f32 rounding across
    the 2S stages, amplified by cond(Tbar).  Tolerance
    4 eps cond(Tbar) sqrt(2S) max(1, max|x|), with cond(Tbar) < 1e4
    required (printed with it).  Returns max|dx|."""
    import numpy as np
    import torch
    cond = float(torch.linalg.cond(t_dense.double()).max())
    stages = 2 * num_stages
    tol = 4 * float(np.finfo(np.float32).eps) * cond * stages ** 0.5
    err, scale = max_err(xr, x)
    log(f"[{tag}] synthesis(analysis(x)) vs x: max|dx| {err:.3e}, "
        f"tolerance {tol:.3e} * {scale:.3e} (max cond(Tbar) {cond:.1f}, "
        f"{stages} stages)")
    check(cond < 1e4, f"{tag}: cond(Tbar) {cond} >= 1e4")
    check(err <= tol * scale, f"{tag}: round trip max|dx| {err:.3e}")
    return err


@contextlib.contextmanager
def fit_iterations(n_iter: int):
    """The fleets the serve CLI builds fit with ``n_iter`` polish passes
    while open (the CLI, as the JAX package's, has no flag for it; the
    engine's default is 3)."""
    from repro_torch.launch import serve
    init = serve.FGFTServeEngine.__init__
    serve.FGFTServeEngine.__init__ = functools.partialmethod(init,
                                                             n_iter=n_iter)
    try:
        yield
    finally:
        serve.FGFTServeEngine.__init__ = init


def phase_main_directed() -> dict:
    """The directed main path through the CLI, then an analysis /
    synthesis round trip through ``ApproxEigenbasis.apply``."""
    import numpy as np
    import torch
    from repro_torch.core.ttransform import t_to_dense
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch import serve
    argv = ["--fgft", "--directed", "--graphs", str(MAIN["graphs"]),
            "--graph-n", str(MAIN["n"]), "--signals", str(MAIN["signals"]),
            "--filter-steps", str(MAIN["steps"]), "--tiers", MAIN["tiers"],
            "--device", DEVICE]
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    with fit_iterations(MAIN["directed_n_iter"]):
        out = serve.main(argv)
    basis = out["engine"].basis
    x = out["signals"]
    xr = basis.apply(basis.apply(x, inverse=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launcher.entry_launch_counts()
    log(f"[main-directed] serve --fgft {' '.join(argv[1:])} + apply round "
        f"trip: {wall:.1f}s (fit {out['fit_s']:.1f}s); launches {launches}")
    for entry in ("batched_gen_operator_apply", "batched_shear_apply"):
        check(launches[entry] > 0, f"directed path never launched {entry}")
    check(basis.kind == "general", f"directed fleet fitted as {basis.kind}")
    engine, laps = out["engine"], out["laps"]
    n = basis.n
    lap_t = torch.from_numpy(laps).to(basis.device)
    t_dense = t_to_dense(basis.factors, n)
    t_inv = t_to_dense(basis.factors, n, inverse=True)
    recon = t_dense @ torch.diag_embed(basis.spectrum) @ t_inv
    dense = (((lap_t - recon) ** 2).sum((1, 2))
             / (lap_t ** 2).sum((1, 2))).cpu().numpy()
    rel = np.asarray(out["rel_error"], np.float64)
    mean_rel, mean_dense = float(rel.mean()), float(dense.mean())
    log(f"[main-directed] full-tier relative error: mean {mean_rel:.6f} "
        f"from the fit objective, {mean_dense:.6f} recomputed densely")
    check(bool(np.isfinite(rel).all()), "non-finite relative error")
    check(mean_rel < 0.05, f"mean relative error {mean_rel} >= 0.05")
    check(abs(mean_dense - mean_rel) <= 1e-3 * mean_rel,
          f"dense relative error {mean_dense} != objective {mean_rel}")
    trip_err = check_round_trip("main-directed", xr, x, t_dense,
                                basis.fwd.num_stages)
    log(f"[main-directed] the fleet's T fit at n_iter "
        f"{MAIN['directed_n_iter']}: {basis.fwd.num_stages} stages, mean "
        f"relative error {mean_rel:.6f} (gate < 0.05)")
    for name, ts in out["tiers"].items():
        log(f"[main-directed] tier {name}: {ts['transforms_per_s']:.1f} "
            f"graph-transforms/s, {ts['num_transforms']} components, "
            f"{ts['num_stages']} stages")
    y = engine.step(x, lowpass, tier="full")
    plain = ApplyPlan(family="general", mode="operator", n=n, batched=True,
                      backend="torch", device=DEVICE).program()
    spec = engine.tiers["full"]["spectrum"]
    y_ref = plain(engine._live.fwd, engine._live.bwd, lowpass(spec), x)
    check(tuple(y.shape) == tuple(x.shape), f"served shape {tuple(y.shape)}")
    err, scale = max_err(y, y_ref)
    check(err == 0.0, f"served full tier max|dy| {err:.3e} (want 0)")
    log(f"[main-directed] served full tier vs plain version: max|dy| "
        f"{err:.3e} (scale {scale:.3e})")
    bank = directed_bank(laps, basis, x)
    return {"out": out, "launches": launches, "wall_s": wall,
            "mean_rel": mean_rel, "mean_rel_dense": mean_dense,
            "served_err": err, "round_trip_err": trip_err, "bank": bank}


def directed_bank(laps, basis, x) -> dict:
    """The directed filter bank on the fitted basis of the directed main
    path (no second T fit): an engine with the bank spec serves one
    warm-up and MAIN["steps"] bank steps with the counters zeroed just
    before; bank and each filter are held bitwise to the plain version
    and to the operator kernel."""
    import torch
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch import serve
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    engine = serve.FGFTServeEngine(laps, basis=basis, kind="general",
                                   filters=MAIN["filters"], device=DEVICE)
    y = engine.step_bank(x)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(MAIN["steps"]):
        y = engine.step_bank(x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = launcher.entry_launch_counts()
    bsz, rows, n = x.shape
    nf = len(engine.bank)
    rate = MAIN["steps"] * bsz * nf / dt
    log(f"[main-directed] bank {MAIN['filters']} on the fitted basis: "
        f"{time.perf_counter() - t0:.1f}s, {rate:.1f} responses/s; "
        f"launches {launches}")
    check(launches["batched_gen_filter_bank_apply"] > 0,
          "directed bank never launched batched_gen_filter_bank_apply")
    check(tuple(y.shape) == (bsz, nf, rows, n), f"bank shape {tuple(y.shape)}")
    live = engine._live
    plain = ApplyPlan(family="general", mode="bank", n=n, batched=True,
                      backend="torch", device=DEVICE).program()
    err, scale = max_err(y, plain(live.fwd, live.bwd, live.bank_gains, x))
    check(err == 0.0, f"directed bank vs plain max|dy| {err:.3e} (want 0)")
    log(f"[main-directed] served bank {list(y.shape)} vs plain version: "
        f"max|dy| {err:.3e} (scale {scale:.3e})")
    check_bank_slices("main-directed", engine, y, x, 0.0)
    return {"engine": engine, "launches": launches, "responses_per_s": rate,
            "served_err": err}


def phase_fgft_directed(errs) -> dict:
    """The single-graph T entry points at the main path's width."""
    import numpy as np
    import torch
    from repro_torch.core import build_fgft, relative_error
    from repro_torch.core.ttransform import t_to_dense
    from repro_torch.kernels import launcher, ref
    from repro_torch.kernels.plan import ApplyPlan
    n = MAIN["n"]
    g = MAIN["single_g"]
    lap = directed_laps(n, 1)[0]
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    x = torch.randn((MAIN["signals"], n), generator=gen, device=DEVICE)
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    f = build_fgft(lap, g, directed=True, n_iter=1, device=DEVICE)
    fit_s = time.perf_counter() - t0
    xh = f.analysis(x)
    xr = f.synthesis(xh)
    y = f.project(x, lowpass)
    gains = bank_gains(f.spectrum)
    yb = ApplyPlan(family="general", mode="bank", n=n, batched=False,
                   device=DEVICE).bank(f.fwd, f.bwd, gains, x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launcher.entry_launch_counts()
    log(f"[single-directed] build_fgft(directed) n={n} g={g} + "
        f"analysis/synthesis/project/bank of R={x.shape[0]}: {wall:.1f}s "
        f"(fit {fit_s:.1f}s); launches {launches}")
    for entry in ("gen_operator_apply", "shear_apply",
                  "gen_filter_bank_apply"):
        check(launches[entry] > 0,
              f"directed single-graph path never launched {entry}")
    rel = relative_error(lap, f)
    log(f"[single-directed] relative error {rel:.6f}, "
        f"{f.fwd.idx_i.shape[0]} stages of {f.fwd.idx_i.shape[1]} entries")
    check(np.isfinite(rel) and rel < 0.05, f"relative error {rel} >= 0.05")
    compare("shear_apply", xh, ref.staged_t_apply(f.bwd, x, None, "tail"),
            errs)
    compare("shear_apply", xr, ref.staged_t_apply(f.fwd, xh), errs)
    compare("gen_operator_apply", y, ref.gen_operator_apply(
        f.fwd, f.bwd, lowpass(f.spectrum), x), errs)
    compare("gen_filter_bank_apply", yb, ref.gen_filter_bank_apply(
        f.fwd, f.bwd, gains, x), errs)
    check_round_trip("single-directed", xr, x,
                     t_to_dense(f.t_factors, n), f.fwd.num_stages)
    return {"fgft": f, "launches": launches, "signals": x, "gains": gains}


def phase_directed_shapes(main, single, errs, precision: str = "f32",
                          launches=None, signal: str = "f32") -> list:
    """T kernels vs plain at the directed paths' shapes (every cut),
    then timings; ``precision``, ``launches`` and ``signal``: as in
    phase_main_shapes."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import shear as sh
    basis = main["out"]["engine"].basis
    fwd, inv = at_precision(precision, basis.fwd, basis.bwd)
    n, bsz = basis.n, basis.spectrum.shape[0]
    dtype = signal_dtype(signal)
    x = main["out"]["signals"].to(dtype)
    f = single["fgft"]
    sfwd, sinv = at_precision(precision, f.fwd, f.bwd)
    sspec, x0 = f.spectrum, single["signals"].to(dtype)
    if signal == "f32":
        gen = torch.Generator(device=DEVICE).manual_seed(17)
        ragged = torch.randn((bsz, 130, n), generator=gen, device=DEVICE)
        check_t_tables(f"main-directed n={n} B={bsz} R={x.shape[1]}", fwd,
                       inv, basis.spectrum, x, errs)
        check_t_tables(f"main-directed n={n} B={bsz} R=130", fwd, inv,
                       basis.spectrum, ragged, errs)
        check_t_tables(f"fgft-directed n={n} B=1 R={x0.shape[0]}", sfwd,
                       sinv, sspec, x0, errs)
    torch.cuda.synchronize()

    # timings at the paths' shapes (full chain); dense yardsticks from
    # the kernels' own output
    eye = torch.eye(n, device=DEVICE)
    tt_rows = sh.batched_shear_apply(
        fwd, eye.expand(bsz, n, n).contiguous())           # rows: Tbar^T
    t_dense = tt_rows.transpose(1, 2).contiguous()
    spec = basis.spectrum
    dense_op = sh.batched_gen_operator_apply(
        fwd, inv, spec,
        eye.expand(bsz, n, n).contiguous()).transpose(1, 2).contiguous()
    st = sh.shear_apply(sfwd, eye).T.contiguous()
    sdense = sh.gen_operator_apply(sfwd, sinv, sspec, eye).T.contiguous()
    t_dense, dense_op, st, sdense = (a.to(dtype) for a in (
        t_dense, dense_op, st, sdense))
    fwd_legs = [real_entries(fwd, None, "head")]
    op_legs = [real_entries(inv, None, "tail")] + fwd_legs
    single_fwd = [real_entries(sfwd, None, "head")]
    single_op = [real_entries(sinv, None, "tail")] + single_fwd
    cases = [
        ("t_operator_kernel", "batched_gen_operator_apply", x, op_legs, 1,
         lambda: sh.batched_gen_operator_apply(fwd, inv, spec, x),
         lambda: ref.batched_gen_operator_apply(fwd, inv, spec, x),
         lambda: torch.bmm(x, dense_op.transpose(1, 2))),
        ("t_chain_kernel", "batched_shear_apply", x, fwd_legs, 0,
         lambda: sh.batched_shear_apply(fwd, x),
         lambda: ref.batched_t_apply(fwd, x),
         lambda: torch.bmm(x, t_dense.transpose(1, 2))),
        ("t_operator_kernel", "gen_operator_apply", x0, single_op, 1,
         lambda: sh.gen_operator_apply(sfwd, sinv, sspec, x0),
         lambda: ref.gen_operator_apply(sfwd, sinv, sspec, x0),
         lambda: torch.mm(x0, sdense.T)),
        ("t_chain_kernel", "shear_apply", x0, single_fwd, 0,
         lambda: sh.shear_apply(sfwd, x0),
         lambda: ref.staged_t_apply(sfwd, x0),
         lambda: torch.mm(x0, st.T)),
    ]
    return timed_rows(cases, main, single, fwd, sfwd, errs, "general",
                      precision, launches, signal)


def sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def masked_gains(basis, gains):
    """``gains`` (B, n) zeroed at the pad coordinates of a ragged basis
    (computed here from ``basis.sizes``, not by the engine)."""
    import torch
    if basis.sizes is None:
        return gains
    valid = (torch.arange(basis.n, device=gains.device)
             < torch.as_tensor(basis.sizes, device=gains.device)[:, None])
    return torch.where(valid, gains, torch.zeros_like(gains))


def ragged_blocks(router, seed: int, rows: int):
    """Random (B_w, R, w) blocks per bucket with NONZERO pad coordinates
    (the pass-through checks need signal there)."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return {w: torch.randn((len(m), rows, w), generator=gen, device=DEVICE)
            for w, m in sorted(router.bucket_of.items())}


def ragged_step_times(tag, calls: dict, kernel: str, launches: int,
                      graphs: int, steps: int = 50) -> dict:
    """Per call (a tier's step or the bank's): the host's enqueue time and
    the synchronized wall time per step over ``steps`` steps, the rate
    (``graphs`` per step), and the profiler's device time of ``kernel``
    per step (``launches`` launches each) with the card's idle share."""
    import torch
    out = {}
    for name, fn in calls.items():
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        t1 = time.perf_counter()
        sync()
        wall = (time.perf_counter() - t0) / steps * 1e3
        enqueue = (t1 - t0) / steps * 1e3
        dev = device_ms(fn, kernel) if torch.cuda.is_available() else None
        dev_step = None if dev is None else dev * launches
        out[name] = {"enqueue_ms": enqueue, "wall_ms": wall,
                     "per_s": graphs / wall * 1e3, "device_ms": dev_step}
        dev_txt = ("not measured" if dev_step is None else
                   f"{dev_step:.4f} ms ({launches} launches), idle "
                   f"{1.0 - dev_step / wall:.2f}")
        log(f"[{tag}] {name}: {steps} steps, host enqueue {enqueue:.4f} "
            f"ms/step, wall {wall:.4f} ms/step ({graphs / wall * 1e3:.1f} "
            f"per s); device {dev_txt}")
    return out


def ragged_host_split(tag, router, x, steps: int = 50) -> dict:
    """Host enqueue time per call of the three parts of a full-tier
    router step: the scatter into padded blocks, the bucket engines'
    steps on those blocks, and the crops (the card finishes its work
    between the parts, so each is the host's alone)."""
    blocks = router._scatter(x)
    ys = {w: router.engines[w].step(b, lowpass) for w, b in blocks.items()}
    parts = {"scatter": lambda: router._scatter(x),
             "engine steps": lambda: {w: router.engines[w].step(b, lowpass)
                                      for w, b in blocks.items()},
             "crops": lambda: router._gather(ys)}
    out = {}
    for name, fn in parts.items():
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        out[name] = (time.perf_counter() - t0) / steps * 1e3
        sync()
    log(f"[{tag}] host enqueue per full-tier step, by part: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in out.items()))
    return out


def check_ragged_pads(tag, router, blocks, tol: float,
                      precision: str = "f32") -> None:
    """Per bucket: ``apply`` (synthesis, analysis and the round trip)
    passes pad coordinates through BITWISE, ``project`` with the heat
    response (h(0) = 1) gives exactly 0 there, and ``apply`` equals its
    plain version (G within ``tol`` * scale, T bitwise), each at the
    table ``precision``."""
    import torch
    from repro_torch.spectral import named_responses
    heat = named_responses("heat")["heat"]
    at = dict(precision=precision)
    for w, eng in sorted(router.engines.items()):
        basis, x = eng.basis, blocks[w]
        y = basis.apply(x, **at)
        xa = basis.apply(x, inverse=True, **at)
        xr = basis.apply(xa, **at)
        p = basis.project(x, h=heat, **at)
        err, scale = max_err(y, basis.apply(x, backend="torch", **at))
        check(err <= tol * scale, f"{tag} bucket {w}: apply vs plain "
              f"max|dy| {err:.3e}")
        sizes = basis.sizes if basis.sizes is not None else [w] * len(x)
        for b, s in enumerate(sizes):
            for name, got in (("synthesis", y), ("analysis", xa),
                              ("round trip", xr)):
                check(torch.equal(got[b, :, s:], x[b, :, s:]),
                      f"{tag} bucket {w} graph {b}: {name} changed its "
                      f"pad coordinates")
            check(bool((p[b, :, s:] == 0).all()),
                  f"{tag} bucket {w} graph {b}: project(heat) is not 0 "
                  f"at the pads")
    sync()
    log(f"[{tag}] pads of every bucket ({precision} tables): synthesis, "
        f"analysis and round trip bitwise the input's; project(heat, "
        f"h(0) = 1) exactly 0")


def check_ragged_served(tag, router, signals, tol: float) -> float:
    """Each bucket's served full-tier output against the plain operator
    program on the same tables and masked gains; every graph's cropped
    answer equals its bucket row and the bucket's pads are 0.  Returns
    the largest max|dy|."""
    import torch
    from repro_torch.kernels.plan import ApplyPlan
    ys = router.step(signals, lowpass, tier="full")
    blocks = router._scatter(signals)
    worst = 0.0
    for w, eng in sorted(router.engines.items()):
        live, basis = eng._live, eng.basis
        plain = ApplyPlan(family=basis.kind, mode="operator", n=w,
                          batched=True, backend="torch",
                          device=DEVICE).program()
        d = masked_gains(basis, lowpass(eng.tiers["full"]["spectrum"]))
        y = eng.step(blocks[w], lowpass, tier="full")
        err, scale = max_err(y, plain(live.fwd, live.bwd, d, blocks[w]))
        check(err <= tol * scale, f"{tag} bucket {w}: served vs plain "
              f"max|dy| {err:.3e} > {tol} * {scale:.3e}")
        worst = max(worst, err)
        for row, pos in enumerate(router.bucket_of[w]):
            n = router.sizes[pos]
            check(ys[pos].device.type == torch.device(DEVICE).type
                  and tuple(ys[pos].shape) == (signals[pos].shape[0], n),
                  f"{tag}: graph {pos} served {tuple(ys[pos].shape)} on "
                  f"{ys[pos].device}")
            check(torch.equal(ys[pos], y[row, :, :n]),
                  f"{tag}: graph {pos} != its bucket row")
            check(bool((y[row, :, n:] == 0).all()),
                  f"{tag}: graph {pos}'s pads are not 0")
    sync()
    log(f"[{tag}] served full tier of every bucket vs the plain version: "
        f"max|dy| {worst:.3e} (tolerance {tol} * scale); crops in request "
        f"order, pads 0")
    return worst


def phase_main_ragged(errs, cfg=None) -> dict:
    """The heterogeneous-fleet path through the CLI: ``serve --fgft
    --ragged``, then save / load of the router and its bank served from
    the restored router (no second fit), then a small directed ragged
    fleet held bitwise to the plain versions."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.core.gtransform import g_to_dense
    from repro_torch.core.staging import table_arrays
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch import serve
    cfg = dict(RAGGED, **(cfg or {}))
    argv = ["--fgft", "--ragged", "--graphs", str(cfg["graphs"]),
            "--graph-sizes", cfg["sizes"], "--transforms",
            str(cfg["transforms"]), "--signals", str(MAIN["signals"]),
            "--filter-steps", str(MAIN["steps"]), "--tiers", MAIN["tiers"],
            "--device", DEVICE]
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.main(argv)
    sync()
    wall = time.perf_counter() - t0
    launches = launcher.entry_launch_counts()
    router = out["router"]
    buckets = {w: len(m) for w, m in sorted(router.bucket_of.items())}
    g = {w: e.basis.num_transforms for w, e in sorted(router.engines.items())}
    log(f"[main-ragged] serve {' '.join(argv)}: {wall:.1f}s (fit "
        f"{out['fit_s']:.1f}s); buckets {buckets}, g per bucket {g}; "
        f"launches {launches}")
    check(buckets == cfg["buckets"], f"buckets {buckets}")
    check(g == cfg["g"], f"g per bucket {g}")
    for entry in ("batched_sym_operator_apply", "batched_butterfly_apply"):
        check(launches[entry] > 0, f"ragged path never launched {entry}")
    for name, ts in out["tiers"].items():
        log(f"[main-ragged] tier {name}: {ts['transforms_per_s']:.1f} "
            f"graph-transforms/s, components per bucket "
            f"{ts['num_transforms']}, stages {ts['num_stages']}")
    x = out["signals"]
    nb = len(router.engines)
    step_times = ragged_step_times(
        "main-ragged", {f"tier {name}": (lambda t=name: router.step(
            x, lowpass, tier=t)) for name in out["tiers"]},
        "g_operator_kernel", nb, len(x))
    host_split = ragged_host_split("main-ragged", router, x)
    # each graph's relative error against a dense recomputation on its
    # cropped block
    rel = np.asarray(out["rel_error"], np.float64)
    dense = np.zeros_like(rel)
    for w, eng in sorted(router.engines.items()):
        basis = eng.basis
        u = g_to_dense(basis.factors, w)
        recon = (u @ torch.diag_embed(basis.spectrum)
                 @ u.transpose(1, 2)).double().cpu().numpy()
        for row, pos in enumerate(router.bucket_of[w]):
            n = router.sizes[pos]
            lap = np.asarray(out["laps"][pos], np.float64)
            dense[pos] = (((lap - recon[row, :n, :n]) ** 2).sum()
                          / (lap ** 2).sum())
    dev_rel = float(np.max(np.abs(dense - rel) / rel))
    log(f"[main-ragged] full-tier relative error: mean {rel.mean():.6f} "
        f"(per bucket " + ", ".join(
            f"{w}: {rel[m].mean():.6f}" for w, m in
            sorted(router.bucket_of.items())) + f"); dense recomputation "
        f"on the cropped blocks: mean {dense.mean():.6f}, worst relative "
        f"deviation {dev_rel:.2e}")
    check(bool(np.isfinite(rel).all()), "non-finite relative error")
    check(float(rel.mean()) < 0.05, f"mean relative error {rel.mean()}")
    check(dev_rel <= 1e-3, f"dense relative error deviates {dev_rel:.3e}")
    served_err = check_ragged_served("main-ragged", router, out["signals"],
                                     TOL)
    errs["batched_sym_operator_apply"] = max(
        errs.get("batched_sym_operator_apply", 0.0), served_err)
    check_ragged_pads("main-ragged", router,
                      ragged_blocks(router, 29, 130), TOL)

    # save / load: the restored router serves the bank without a refit
    ckpt = ROOT / "build" / "ragged_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    router.save(ckpt)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = serve.RaggedFGFTServeEngine.load(
        ckpt, filters=MAIN["filters"], device=DEVICE)
    sync()
    load_s = time.perf_counter() - t0
    size_mb = sum(p.stat().st_size for p in ckpt.rglob("*")
                  if p.is_file()) / 2 ** 20
    check(restored.widths == router.widths
          and restored.bucket_of == router.bucket_of, "restored geometry")
    for w, eng in router.engines.items():
        back = restored.engines[w]
        for leg in ("fwd", "bwd"):
            for a, b in zip(table_arrays(getattr(eng.basis, leg)),
                            table_arrays(getattr(back.basis, leg))):
                check(torch.equal(a, b), f"bucket {w}: restored {leg} "
                      f"tables differ")
    for tier in router.engines[max(router.engines)].tiers:
        for pos, (a, b) in enumerate(zip(router.step(x, lowpass, tier=tier),
                                         restored.step(x, lowpass,
                                                       tier=tier))):
            check(torch.equal(a, b), f"restored router, tier {tier}: "
                  f"graph {pos} differs")
    sync()
    log(f"[main-ragged] router saved in {save_s:.2f}s ({size_mb:.1f} MiB, "
        f"{len(router.engines)} bucket checkpoints) and loaded with filters "
        f"{MAIN['filters']} in {load_s:.2f}s; staged tables bitwise equal, "
        f"every tier's steps bitwise equal to the saved router's")
    restored.step_bank(x)                       # warmup: not counted
    sync()
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(MAIN["steps"]):
        yb = restored.step_bank(x)
    sync()
    dt = time.perf_counter() - t0
    bank_launches = launcher.entry_launch_counts()
    nf = len(restored.engines[max(restored.engines)].bank)
    rate = MAIN["steps"] * len(x) * nf / dt
    log(f"[main-ragged] restored router's bank ({nf} filters): "
        f"{rate:.1f} responses/s; launches {bank_launches}")
    step_times.update(ragged_step_times(
        "main-ragged", {"bank": lambda: restored.step_bank(x)},
        "g_bank_kernel", nb, len(x) * nf))
    check(bank_launches["batched_sym_filter_bank_apply"]
          == MAIN["steps"] * len(restored.engines),
          "the restored router's bank did not launch once per bucket "
          "and step")
    blocks = restored._scatter(x)
    plain_bank = {}
    for w, eng in sorted(restored.engines.items()):
        live = eng._live
        y = eng.step_bank(blocks[w])
        plain = ApplyPlan(family="sym", mode="bank", n=w, batched=True,
                          backend="torch", device=DEVICE).program()
        err, scale = max_err(y, plain(live.fwd, live.bwd, live.bank_gains,
                                      blocks[w]))
        check(err <= TOL * scale, f"bucket {w}: bank vs plain max|dy| "
              f"{err:.3e}")
        plain_bank[w] = err
        errs["batched_sym_filter_bank_apply"] = max(
            errs.get("batched_sym_filter_bank_apply", 0.0), err)
        check_bank_slices(f"main-ragged bucket {w}", eng, y, blocks[w], TOL)
        for row, pos in enumerate(restored.bucket_of[w]):
            n = restored.sizes[pos]
            check(bool((y[row, :, :, n:] == 0).all()),
                  f"bucket {w}: bank pads of graph {pos} are not 0")
            check(torch.equal(yb[pos], y[row, :, :, :n]),
                  f"bank of graph {pos} != its bucket row")
    log(f"[main-ragged] bank of every bucket vs plain version: max|dy| "
        f"{plain_bank}; pads 0")
    directed = ragged_directed(cfg)
    return {"out": out, "launches": launches, "wall_s": wall,
            "mean_rel": float(rel.mean()), "dense_dev": dev_rel,
            "served_err": served_err, "save_s": save_s, "load_s": load_s,
            "checkpoint_mib": size_mb, "bank_responses_per_s": rate,
            "step_times": step_times, "host_split": host_split,
            "bank_launches": bank_launches, "directed": directed}


def ragged_directed(cfg) -> dict:
    """A small directed ragged fleet (T fit, n_iter = 1): the T operator,
    chain and bank of every bucket held BITWISE to their plain versions,
    and the pads passed through bitwise."""
    import torch
    from repro_torch.core import laplacian
    from repro_torch.graphs import community_graph, directed_variant
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch import serve
    sizes = [int(s) for s in cfg["directed_sizes"].split(",")]
    sizes = [sizes[i % len(sizes)] for i in range(cfg["directed_graphs"])]
    laps = [laplacian(directed_variant(community_graph(n, seed=s), seed=s))
            for s, n in enumerate(sizes)]
    launcher.reset_launch_counts()
    t0 = time.perf_counter()
    router = serve.RaggedFGFTServeEngine(
        laps, n_iter=1, kind="general", filters=MAIN["filters"],
        tiers={"full": 1.0}, device=DEVICE)
    sync()
    fit_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    x = [torch.randn((MAIN["signals"], n), generator=gen, device=DEVICE)
         for n in sizes]
    ys = router.step(x, lowpass)
    yb = router.step_bank(x)
    blocks = ragged_blocks(router, 37, MAIN["signals"])
    for eng in router.engines.values():
        eng.basis.apply(eng.basis.apply(blocks[eng.basis.n], inverse=True))
    sync()
    launches = launcher.entry_launch_counts()
    rel = router.rel_errors()
    log(f"[ragged-directed] {len(sizes)} directed graphs (sizes "
        f"{sorted(set(sizes))}) in buckets "
        f"{ {w: len(m) for w, m in sorted(router.bucket_of.items())} }: "
        f"fit {fit_s:.1f}s, mean rel error {rel.mean():.6f}; launches "
        f"{launches}")
    for entry in ("batched_gen_operator_apply", "batched_shear_apply",
                  "batched_gen_filter_bank_apply"):
        check(launches[entry] > 0, f"directed ragged check never launched "
              f"{entry}")
    check(router.engines[max(router.engines)].basis.kind == "general",
          "directed fleet fitted as sym")
    xb = router._scatter(x)
    for w, eng in sorted(router.engines.items()):
        live, basis = eng._live, eng.basis
        d = masked_gains(basis, lowpass(eng.tiers["full"]["spectrum"]))
        op = ApplyPlan(family="general", mode="operator", n=w, batched=True,
                       backend="torch", device=DEVICE).program()
        bank = ApplyPlan(family="general", mode="bank", n=w, batched=True,
                         backend="torch", device=DEVICE).program()
        checks = (("batched_gen_operator_apply", eng.step(xb[w], lowpass),
                   op(live.fwd, live.bwd, d, xb[w])),
                  ("batched_gen_filter_bank_apply", eng.step_bank(xb[w]),
                   bank(live.fwd, live.bwd, live.bank_gains, xb[w])),
                  ("batched_shear_apply", basis.apply(blocks[w]),
                   basis.apply(blocks[w], backend="torch")),
                  ("batched_shear_apply", basis.apply(blocks[w],
                                                      inverse=True),
                   basis.apply(blocks[w], inverse=True, backend="torch")))
        for entry, got, want in checks:
            check(torch.equal(got, want), f"directed bucket {w}: {entry} "
                  f"!= its plain version (want bitwise)")
        for row, pos in enumerate(router.bucket_of[w]):
            n = sizes[pos]
            check(torch.equal(ys[pos], eng.step(xb[w], lowpass)[row, :, :n]),
                  f"directed graph {pos} != its bucket row")
            check(bool((yb[pos] == eng.step_bank(xb[w])[row, :, :, :n]).all()),
                  f"directed bank of graph {pos} != its bucket row")
    check_ragged_pads("ragged-directed", router, blocks, 0.0)
    log("[ragged-directed] T operator, chain (both legs) and bank of every "
        "bucket bitwise equal to their plain versions")
    return {"launches": launches, "fit_s": fit_s,
            "mean_rel": float(rel.mean())}


@contextlib.contextmanager
def uncounted():
    """Launches inside (comparisons with the plain versions, error
    checks) leave the launch counts as they were."""
    from repro_torch.kernels import launcher
    saved = launcher.entry_launch_counts()
    try:
        yield
    finally:
        launcher.reset_launch_counts()
        launcher._launches.update(saved)


def device_total_ms(fn, kernel: str, reps: int = 5, traces: int = 5):
    """Device time per call of fn summed over every kernel it launches
    (torch.profiler's CUDA events), from a trace that holds all ``reps``
    launches of ``kernel`` (a trace now and then drops events); None
    when no trace does."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == DeviceType.CUDA]
        if sum(e.count for e in events if kernel in e.key) != reps:
            continue
        total = sum(getattr(e, "device_time_total", None)
                    or getattr(e, "cuda_time_total", 0.0) for e in events)
        return total / 1e3 / reps
    return None


def table_shape(basis) -> str:
    s, p = basis.fwd.idx_i.shape[-2:]
    return f"(S, P) = ({s}, {p}), g = {basis.num_transforms}"


def dense_rel_error(basis, laps):
    """Per-graph ||L - U diag(s) U^T||^2 / ||L||^2 from the dense chain
    (plain torch: g_to_dense / t_to_dense)."""
    import torch
    from repro_torch.core.gtransform import g_to_dense
    from repro_torch.core.ttransform import t_to_dense
    lap = torch.as_tensor(laps, dtype=torch.float32).to(basis.device)
    if basis.kind == "sym":
        u = g_to_dense(basis.factors, basis.n)
        recon = u @ torch.diag_embed(basis.spectrum) @ u.transpose(-1, -2)
    else:
        recon = (t_to_dense(basis.factors, basis.n)
                 @ torch.diag_embed(basis.spectrum)
                 @ t_to_dense(basis.factors, basis.n, inverse=True))
    return (((lap - recon) ** 2).sum((-2, -1))
            / (lap ** 2).sum((-2, -1))).cpu().numpy()


def check_swap(tag, engine, x, y, errs, structural: bool) -> dict:
    """After a hot swap: the served full tier (y on x) against the plain
    operator on the live tables; the full-tier relative error through the
    operator kernel (``exact_rel_residual``) and, when the swap was a
    ``structural`` fit (EXTEND, REFIT) on the tracked Laplacians, from
    its objective, each against the dense recomputation within 1e-3
    relative."""
    import numpy as np
    from repro_torch.dynamic import exact_rel_residual
    from repro_torch.kernels.plan import ApplyPlan
    live, basis = engine._live, engine.basis
    with uncounted():
        plain = ApplyPlan(family=basis.kind, mode="operator", n=basis.n,
                          batched=True, backend="torch",
                          device=DEVICE).program()
        want = plain(live.fwd, live.bwd,
                     lowpass(live.tiers[engine.default_tier]["spectrum"]), x)
        err, scale = max_err(y, want)
        entry = ("batched_sym_operator_apply" if basis.kind == "sym"
                 else "batched_gen_operator_apply")
        tol = tolerance(entry)
        check(err <= tol * scale, f"{tag}: served full tier vs plain "
              f"max|dy| {err:.3e} > {tol} * {scale:.3e}")
        errs[entry] = max(errs.get(entry, 0.0), err)
        laps = engine._laps
        dense = dense_rel_error(basis, laps)
        kern = exact_rel_residual(basis, laps)
        dev = float(np.max(np.abs(kern - dense) / dense))
        check(dev <= 1e-3, f"{tag}: relative error through the kernel "
              f"deviates {dev:.2e} from the dense recomputation")
        obj_dev = None
        if structural:
            from repro_torch.dynamic import relative_objective
            rel = relative_objective(basis.objective, laps)
            obj_dev = float(np.max(np.abs(rel - dense) / dense))
            check(obj_dev <= 1e-3, f"{tag}: objective relative error "
                  f"deviates {obj_dev:.2e} from the dense recomputation")
    log(f"[{tag}] served full tier vs plain max|dy| {err:.3e} (scale "
        f"{scale:.3e}); full-tier relative error mean {dense.mean():.6f} "
        f"dense, kernel deviation {dev:.2e}"
        + ("" if obj_dev is None else f", objective deviation {obj_dev:.2e}")
        + f"; {table_shape(basis)}")
    return {"served_err": err, "rel_error": float(dense.mean()),
            "kernel_dev": dev, "objective_dev": obj_dev}


def update_round(engine, stream, churn: float, seed: int,
                 directed: bool = False, graphs=None) -> None:
    """One ``edge_perturbation`` batch at ``churn`` of the edge slots for
    each graph (or those listed), through the stream into the engine."""
    from repro_torch.graphs import edge_perturbation
    for gid in (range(len(stream)) if graphs is None else graphs):
        n = stream.sizes[gid]
        batch = edge_perturbation(stream.adjs[gid],
                                  max(int(churn * n * (n - 1) / 2), 1),
                                  seed=seed + gid, directed=directed)
        engine.apply_updates(gid, stream.apply(gid, batch))


def forced_tick(tag, engine, want: str, **thresholds) -> dict:
    """One maintain tick under a policy whose thresholds are the given
    multiples of the engine's current maximum drift, so that the ladder
    takes ``want``; timed, with the stream cache's hits and misses.  A
    quiet tick first (every threshold out of reach: REUSE) clears a
    hysteresis floor that an earlier action left standing."""
    from dataclasses import replace
    import torch
    from repro_torch.kernels import launcher
    policy = engine.controller.policy
    engine.controller.policy = replace(policy, refresh=1e9, extend=1e9,
                                       refit=1e9)
    check(engine.maintain()["action"] == "reuse", f"{tag}: quiet tick")
    d = float(engine.drift().max())
    check(d > 0, f"{tag}: no drift to act on")
    engine.controller.policy = replace(
        policy, **{k: v * d for k, v in thresholds.items()})
    launcher.reset_stream_cache_counts()
    t0 = time.perf_counter()
    res = engine.maintain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cache = launcher.stream_cache_counts()
    check(res["action"] == want, f"{tag}: took {res['action']}, want {want}")
    split = engine.maintain_ms
    log(f"[{tag}] {want}: drift {d:.5f} -> {float(res['post_drift'].max()):.5f}"
        f" in {wall:.3f}s (drift probe {split['drift']:.1f} ms, action "
        f"{split['action']:.1f} ms, install {split['install']:.1f} ms, "
        f"post-action probe {split['post_drift']:.1f} ms); stream cache "
        f"{cache}; {table_shape(engine.basis)}")
    return {"action": want, "drift": d, "wall_s": wall,
            "split_ms": dict(split), "stream_cache": cache,
            "post_drift": float(res["post_drift"].max())}


def hold_pinned(tag, engine, bank_engine, x, errs) -> None:
    """Every kernel of the dynamic path against its plain version on the
    engine's pinned (and extended) tables: the operator at R = 256 and at
    the probe's R = 8 (every cut at R = 8, the full chain at R = 256),
    the chain on the identity block at every cut, the bank (F = 7)
    served by ``bank_engine`` on the same basis."""
    import torch
    from repro_torch.kernels import butterfly as bf
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import ApplyPlan
    basis = engine.basis
    fwd, bwd, spec = basis.fwd, basis.bwd, basis.spectrum
    bsz, n = spec.shape
    x8 = x[:, :8].contiguous()
    eye = torch.eye(n, device=DEVICE).expand(bsz, n, n).contiguous()
    with uncounted():
        compare("batched_sym_operator_apply",
                bf.batched_sym_operator_apply(fwd, bwd, spec, x),
                ref.batched_sym_operator_apply(fwd, bwd, spec, x), errs)
        for k in [None, *cut_list(fwd)]:
            compare("batched_sym_operator_apply",
                    bf.batched_sym_operator_apply(fwd, bwd, spec, x8, k),
                    ref.batched_sym_operator_apply(fwd, bwd, spec, x8, k),
                    errs)
            compare("batched_butterfly_apply",
                    bf.batched_butterfly_apply(fwd, eye, k, "tail"),
                    ref.batched_g_apply(fwd, eye, k, "tail"), errs)
        live = bank_engine._live
        plain = ApplyPlan(family="sym", mode="bank", n=n, batched=True,
                          backend="torch", device=DEVICE).program()
        yb = bank_engine.step_bank(x)
        compare("batched_sym_filter_bank_apply", yb,
                plain(live.fwd, live.bwd, live.bank_gains, x), errs)
        check_bank_slices(tag, bank_engine, yb, x, TOL)
    sync()
    log(f"[{tag}] operator (R = {x.shape[1]} full, R = 8 at every cut), "
        f"chain on the identity at every cut and bank (F = "
        f"{len(bank_engine.bank)}) vs plain on {table_shape(basis)}: "
        f"max|dy| operator {errs['batched_sym_operator_apply']:.3e}, chain "
        f"{errs['batched_butterfly_apply']:.3e}, bank "
        f"{errs['batched_sym_filter_bank_apply']:.3e}")


def phase_main_dynamic(errs, main_dir) -> dict:
    """The evolving-fleet path: a. ``serve --fgft --dynamic`` at full
    width through the CLI, each swap checked; b. REFRESH and EXTEND forced
    on the same engine, every kernel held to its plain version on the
    pinned and extended tables; c. a REFIT on a small fleet; d. the
    directed engine on [main-directed]'s basis; e. [main-ragged]'s saved
    router loaded dynamic.  Counts are zeroed before each driven part
    and read after it; comparisons do not count."""
    from collections import Counter
    import numpy as np
    import torch
    from repro_torch.dynamic import GraphStream, RefitPolicy
    from repro_torch.graphs import community_graph, directed_variant
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    counts: Counter = Counter()

    def driven(fn):
        launcher.reset_launch_counts()
        out = fn()
        sync()
        counts.update(launcher.entry_launch_counts())
        return out

    cfg = DYNAMIC
    # a. the CLI at full width, each swap checked after its round
    argv = ["--fgft", "--dynamic", "--graphs", str(cfg["graphs"]),
            "--graph-n", str(cfg["n"]), "--transforms",
            str(cfg["transforms"]), "--signals", str(cfg["signals"]),
            "--update-rounds", str(cfg["rounds"]), "--churn",
            str(cfg["churn"]), "--filter-steps", str(MAIN["steps"]),
            "--device", DEVICE]
    swaps = []

    def on_round(rnd, engine, rec, x, y):
        seen = launcher.entry_launch_counts()
        cache = launcher.stream_cache_counts()
        for entry in ("batched_sym_operator_apply",
                      "batched_butterfly_apply"):
            check(seen[entry] > 0, f"[main-dynamic] round {rnd}: "
                  f"{entry} never launched")
        swaps.append({**rec, "stream_cache": cache,
                      **check_swap(f"main-dynamic round {rnd}", engine, x,
                                   y, errs, rec["action"] in ("extend",
                                                              "refit"))})
        log(f"[main-dynamic] round {rnd}: {rec['action']}, stream cache "
            f"{cache} (since the previous round's checks)")
        launcher.reset_stream_cache_counts()

    launcher.reset_stream_cache_counts()
    t0 = time.perf_counter()
    out = driven(lambda: serve.serve_fgft_dynamic(serve.parse_args(argv),
                                                  on_round=on_round))
    wall_a = time.perf_counter() - t0
    engine, stream = out["engine"], out["stream"]
    log(f"[main-dynamic] serve {' '.join(argv)}: {wall_a:.1f}s (fit "
        f"{out['fit_s']:.1f}s); actions {out['actions']}; launches "
        f"{dict(counts)}")
    check(engine.basis.fwd.idx_i.shape[-1] == cfg["n"] // 2,
          "pinned G tables are not n/2 wide")
    gen = torch.Generator(device=DEVICE).manual_seed(41)
    x = torch.randn((cfg["graphs"], cfg["signals"], cfg["n"]),
                    generator=gen, device=DEVICE)
    # the probe and the refresh on the full-width pinned tables
    from repro_torch.dynamic import lemma1_refresh
    probe = {"ms": time_ms(engine.drift, reps=5, rounds=3),
             "device_ms": device_total_ms(engine.drift,
                                          "g_operator_kernel"),
             "kernel_device_ms": device_ms(engine.drift,
                                           "g_operator_kernel")}
    refresh = {"ms": time_ms(lambda: lemma1_refresh(engine.basis,
                                                    engine._laps),
                             reps=5, rounds=3),
               "device_ms": device_total_ms(
                   lambda: lemma1_refresh(engine.basis, engine._laps),
                   "g_chain_kernel"),
               "kernel_device_ms": device_ms(
                   lambda: lemma1_refresh(engine.basis, engine._laps),
                   "g_chain_kernel")}
    step = {"ms": time_ms(lambda: engine.step(x, lowpass)),
            "device_ms": device_ms(lambda: engine.step(x, lowpass),
                                   "g_operator_kernel")}
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"  # noqa: E731
    log(f"[main-dynamic] drift probe (R = 8, B = {cfg['graphs']}): "
        f"{probe['ms']:.4f} ms a call, device {fmt(probe['device_ms'])} ms "
        f"(operator kernel {fmt(probe['kernel_device_ms'])}); Lemma-1 "
        f"refresh: {refresh['ms']:.4f} ms, device "
        f"{fmt(refresh['device_ms'])} ms (chain kernel "
        f"{fmt(refresh['kernel_device_ms'])}); full-tier step "
        f"{step['ms']:.4f} ms, device {fmt(step['device_ms'])} ms on "
        f"{table_shape(engine.basis)}")

    # b. REFRESH then EXTEND, forced at full width
    taken = {a for a in out["actions"]}
    forced = []
    driven(lambda: update_round(engine, stream, cfg["forced_churn"], 7000))
    forced.append(driven(lambda: forced_tick(
        "main-dynamic forced", engine, "refresh", refresh=0.5, extend=4.0,
        refit=8.0)))
    driven(lambda: update_round(engine, stream, cfg["churn"], 8000))
    g_before = engine.basis.num_transforms
    forced.append(driven(lambda: forced_tick(
        "main-dynamic forced", engine, "extend", refresh=0.25, extend=0.5,
        refit=8.0)))
    check(engine.basis.num_transforms
          == g_before + round(0.125 * cfg["transforms"]),
          f"EXTEND grew the chain from {g_before} to "
          f"{engine.basis.num_transforms}")
    y = driven(lambda: engine.step(x, lowpass))
    swaps.append(check_swap("main-dynamic extended", engine, x, y, errs,
                            True))
    bank_engine = serve.FGFTServeEngine(
        engine._laps, basis=engine.basis, filters=MAIN["filters"],
        tiers={"full": 1.0}, device=DEVICE)
    driven(lambda: bank_engine.step_bank(x))
    hold_pinned("main-dynamic pinned", engine, bank_engine, x, errs)
    taken |= {"refresh", "extend"}

    # c. REFIT on a small fleet: the chain returns to g0
    small = cfg["small"]
    sstream = GraphStream([community_graph(small["n"], seed=100 + s)
                           for s in range(small["graphs"])])
    g0 = int(2 * small["n"] * np.log2(small["n"]))
    seng = driven(lambda: serve.FGFTServeEngine(
        np.stack(sstream.laplacians()), g0, dynamic=True,
        policy=RefitPolicy(max_extends=1), device=DEVICE))
    driven(lambda: update_round(seng, sstream, 0.05, 9000))
    refit_ticks = [driven(lambda: forced_tick(
        "main-dynamic small", seng, "extend", refresh=0.25, extend=0.5,
        refit=8.0))]
    check(seng.basis.num_transforms > g0, "small fleet did not extend")
    driven(lambda: update_round(seng, sstream, 0.05, 9100))
    refit_ticks.append(driven(lambda: forced_tick(
        "main-dynamic small", seng, "refit", refresh=0.25, extend=0.5,
        refit=8.0)))
    check(seng.basis.num_transforms == g0,
          f"REFIT chain has {seng.basis.num_transforms} != g0 = {g0}")
    check(seng.controller.extends_since_refit == 0,
          "extends_since_refit is not 0 after the REFIT")
    xs = torch.randn((small["graphs"], 32, small["n"]), generator=gen,
                     device=DEVICE)
    swaps.append(check_swap("main-dynamic small refit", seng, xs,
                            driven(lambda: seng.step(xs, lowpass)), errs,
                            True))

    # d. directed: the [main-directed] basis, no new fit
    dbasis = main_dir["out"]["engine"].basis
    dstream = GraphStream([directed_variant(community_graph(cfg["n"],
                                                            seed=s), seed=s)
                           for s in range(cfg["graphs"])], directed=True)
    check(np.array_equal(np.stack(dstream.laplacians()),
                         main_dir["out"]["laps"]),
          "directed stream differs from [main-directed]'s Laplacians")
    deng = driven(lambda: serve.FGFTServeEngine(
        main_dir["out"]["laps"], basis=dbasis, dynamic=True,
        policy=RefitPolicy(extend_fraction=cfg["directed_extend_fraction"]),
        device=DEVICE))
    check(deng.basis.fwd.idx_i.shape[-1] == cfg["n"],
          "pinned T tables are not n wide")
    driven(lambda: update_round(deng, dstream, cfg["churn"], 9500,
                                directed=True))
    directed_tick = driven(lambda: forced_tick(
        "main-dynamic directed", deng, "extend", refresh=0.5, extend=4.0,
        refit=8.0))
    xd = main_dir["out"]["signals"]
    for tier in deng.tiers:
        got = driven(lambda: deng.step(xd, lowpass, tier=tier))
        with uncounted():
            live = deng._live
            want = ApplyPlan(family="general", mode="operator", n=cfg["n"],
                             batched=True, backend="torch", device=DEVICE,
                             num_stages=(None if tier == deng.default_tier
                                         else live.tiers[tier]["num_stages"])
                             ).program()(live.fwd, live.bwd, lowpass(
                                 live.tiers[tier]["spectrum"]), xd)
        check(torch.equal(got, want), f"directed dynamic tier {tier} != "
              f"its plain version (want bitwise)")
    log(f"[main-dynamic directed] every tier bitwise equal to its plain "
        f"version on {table_shape(deng.basis)}")

    # e. [main-ragged]'s saved router, loaded dynamic
    ckpt = ROOT / "build" / "ragged_checkpoint"
    t0 = time.perf_counter()
    router = driven(lambda: serve.RaggedFGFTServeEngine.load(
        ckpt, dynamic=True, policy=RefitPolicy(
            refresh=1e-9, extend=10.0, refit=20.0, num_probes=64),
        device=DEVICE))
    load_s = time.perf_counter() - t0
    sizes = router.sizes
    rstream = GraphStream([community_graph(n, seed=s)
                           for s, n in enumerate(sizes)])
    moved = sorted({router.widths[0], router.widths[3]})
    check(len(moved) == 2 and len(router.engines) == 3,
          f"ragged buckets {sorted(router.engines)}")
    before = router.versions.copy()
    driven(lambda: update_round(router, rstream, cfg["forced_churn"], 9900,
                                graphs=[0, 3]))
    res = driven(lambda: router.maintain(dirty_only=True))
    after = router.versions
    check(sorted(res) == moved, f"dirty_only ticked buckets {sorted(res)}")
    check(all(r["action"] == "refresh" for r in res.values()),
          f"updated buckets took {[r['action'] for r in res.values()]}")
    for pos, w in enumerate(router.widths):
        want_bump = pos in (0, 3)
        check((after[pos] > before[pos]) == want_bump,
              f"graph {pos} (bucket {w}): version {before[pos]} -> "
              f"{after[pos]}")
    blocks = ragged_blocks(router, 43, 64)
    signals = [torch.randn((64, n), generator=gen, device=DEVICE)
               for n in sizes]
    driven(lambda: router.step(signals, lowpass))
    with uncounted():
        for w, eng in sorted(router.engines.items()):
            p = eng.basis.project(blocks[w], h=lambda lam: torch.exp(-lam))
            for row, pos in enumerate(router.bucket_of[w]):
                check(bool((p[row, :, sizes[pos]:] == 0).all()),
                      f"bucket {w}: project pads of graph {pos} are not 0")
    with uncounted():
        ragged_served = check_ragged_served("main-dynamic ragged", router,
                                            signals, TOL)
    log(f"[main-dynamic ragged] router loaded dynamic in {load_s:.2f}s; "
        f"buckets {moved} acted ({ {w: r['action'] for w, r in res.items()} }"
        f"), versions moved only there; pads 0 from project")

    path = ("batched_sym_operator_apply", "batched_butterfly_apply",
            "batched_gen_operator_apply", "batched_sym_filter_bank_apply")
    for entry in path:
        check(counts[entry] > 0, f"dynamic path never launched {entry}")
    check({"refresh", "extend"} <= taken, f"actions taken {taken}")
    phase_s = time.perf_counter() - t_phase
    log(f"[main-dynamic] {phase_s:.1f}s in all; launches {dict(counts)}")
    return {"out": out, "launches": dict(counts), "swaps": swaps,
            "forced": forced, "refit": refit_ticks,
            "directed": directed_tick, "probe": probe, "refresh": refresh,
            "step": step, "ragged_load_s": load_s,
            "ragged_served_err": ragged_served, "phase_s": phase_s,
            "fit_s": out["fit_s"], "wall_a_s": wall_a}


def rel_dev(got, want) -> float:
    """||got - want|| / ||want|| over the whole block."""
    import torch
    return float(torch.linalg.norm((got - want).double())
                 / torch.linalg.norm(want.double()).clamp(min=1e-30))


def served_rates(engine, x, steps: int) -> dict:
    """graph-transforms/s of every tier and responses/s of the bank of an
    engine (one uncounted warm-up each, then ``steps`` timed steps)."""
    import torch
    out = {}
    calls = {f"tier {t}": (lambda t=t: engine.step(x, lowpass, tier=t))
             for t in engine.tiers}
    if engine.bank is not None:
        calls["bank"] = lambda: engine.step_bank(x)
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        per = x.shape[0] * (len(engine.bank) if name == "bank" else 1)
        out[name] = steps * per / (time.perf_counter() - t0)
    return out


def phase_main_bf16(errs, main, filt, single, main_dir, single_dir) -> dict:
    """[main-bf16]: bf16 table storage end to end, each part driven with
    the counts zeroed just before and read just after (comparisons not
    counted).  a. ``serve --fgft --precision bf16 --filter ...`` at full
    width through the CLI (one G fit): the bank against its plain version
    and each filter against dense eigh within its bound.  b. engines at
    ``precision="bf16"`` on [main]'s and [main-directed]'s bases (no
    fit): every tier and the bank against the plain versions, the full
    tier against the f32 engine (relative deviation < 0.03), rates beside
    the f32 ones, and an ``apply`` round trip at bf16.  c. [main-ragged]'s
    saved router loaded at bf16: pads bitwise through ``apply``, 0 from
    ``project``, served buckets against plain.  d. a dynamic engine at
    bf16 on [main]'s basis with one forced REFRESH: every step after the
    swap hits the entry-stream cache.  e. the single-graph paths at bf16
    (analysis, synthesis, project, bank).  Every bf16 form must have
    launched."""
    from collections import Counter
    import numpy as np
    import torch
    from repro_torch.core.staging import table_arrays
    from repro_torch.dynamic import GraphStream, RefitPolicy
    from repro_torch.graphs import community_graph
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    counts: Counter = Counter()

    def driven(fn):
        launcher.reset_launch_counts()
        out = fn()
        sync()
        counts.update(launcher.entry_launch_counts())
        return out

    def plain(kind, mode, n, **kw):
        return ApplyPlan(family=kind, mode=mode, n=n, batched=True,
                         backend="torch", precision="bf16", device=DEVICE,
                         **kw).program()

    # a. the CLI at full width
    argv = ["--fgft", "--precision", "bf16", "--filter", MAIN["filters"],
            "--graphs", str(MAIN["graphs"]), "--graph-n", str(MAIN["n"]),
            "--transforms", str(int(2 * MAIN["n"] * np.log2(MAIN["n"]))),
            "--signals", str(MAIN["signals"]), "--filter-steps",
            str(MAIN["steps"]), "--device", DEVICE]
    t0 = time.perf_counter()
    out = driven(lambda: serve.main(argv))
    wall = time.perf_counter() - t0
    engine, x = out["engine"], out["signals"]
    live = engine._live
    log(f"[main-bf16] serve {' '.join(argv)}: {wall:.1f}s (fit "
        f"{out['fit_s']:.1f}s), {out['responses_per_s']:.1f} responses/s "
        f"(f32 [main-filter]: {filt['out']['responses_per_s']:.1f}); "
        f"launches { {k: v for k, v in counts.items() if v} }")
    check(engine._precision == "bf16"
          and all(t.dtype == torch.bfloat16 for t in live.fwd[2:]),
          "the bf16 CLI engine does not serve bf16 tables")
    check(counts["batched_sym_filter_bank_apply_bf16"] > 0
          and counts["batched_sym_filter_bank_apply"] == 0,
          "the bf16 CLI did not serve through the bf16 bank form")
    with uncounted():
        y = engine.step_bank(x)
        err, scale = max_err(y, plain("sym", "bank", engine.basis.n)(
            live.fwd, live.bwd, live.bank_gains, x))
        check(err <= TOL * scale, f"[main-bf16] bank vs plain max|dy| "
              f"{err:.3e}")
        errs["batched_sym_filter_bank_apply_bf16"] = max(
            errs.get("batched_sym_filter_bank_apply_bf16", 0.0), err)
        log(f"[main-bf16] served bank {list(y.shape)} vs plain version: "
            f"max|dy| {err:.3e} (scale {scale:.3e})")
        cli_worst = check_filters_dense("main-bf16", engine, y, x,
                                        out["laps"], out["rel_error"])

    # b. engines at bf16 on the f32 paths' bases, no fit
    engines = {}
    for tag, rec, f32_bank in (
            ("main", main, filt["out"]["responses_per_s"]),
            ("main-directed", main_dir, main_dir["bank"]["responses_per_s"])):
        f32_eng, laps, xs = (rec["out"]["engine"], rec["out"]["laps"],
                             rec["out"]["signals"])
        basis = f32_eng.basis
        eng = driven(lambda: serve.FGFTServeEngine(
            laps, basis=basis, tiers=serve.parse_tiers(MAIN["tiers"]),
            filters=MAIN["filters"], precision="bf16", device=DEVICE))
        rates = driven(lambda: served_rates(eng, xs, MAIN["steps"]))
        yr = driven(lambda: basis.apply(basis.apply(
            xs, inverse=True, precision="bf16"), precision="bf16"))
        with uncounted():
            kind, n, lv = basis.kind, basis.n, eng._live
            tol = TOL if kind == "sym" else 0.0
            for tier in eng.tiers:
                k = lv.tiers[tier]["num_stages"]
                want = plain(kind, "operator", n, num_stages=(
                    None if tier == eng.default_tier else k))(
                        lv.fwd, lv.bwd, lowpass(lv.tiers[tier]["spectrum"]),
                        xs)
                err, scale = max_err(eng.step(xs, lowpass, tier=tier), want)
                check(err <= tol * scale, f"[main-bf16 {tag}] tier {tier} vs "
                      f"plain max|dy| {err:.3e}")
                entry = launcher.form(
                    "batched_sym_operator_apply" if kind == "sym"
                    else "batched_gen_operator_apply", "bf16")
                errs[entry] = max(errs.get(entry, 0.0), err)
            y16 = eng.step(xs, lowpass)
            dev = rel_dev(y16, f32_eng.step(xs, lowpass))
            check(dev < 0.03, f"[main-bf16 {tag}] full tier deviates {dev:.4f}"
                  f" from the f32 engine")
            yb = eng.step_bank(xs)
            err, scale = max_err(yb, plain(kind, "bank", n)(
                lv.fwd, lv.bwd, lv.bank_gains, xs))
            check(err <= tol * scale, f"[main-bf16 {tag}] bank vs plain "
                  f"max|dy| {err:.3e}")
            bank_entry = launcher.form(
                "batched_sym_filter_bank_apply" if kind == "sym"
                else "batched_gen_filter_bank_apply", "bf16")
            errs[bank_entry] = max(errs.get(bank_entry, 0.0), err)
            f32_bank_fn = ApplyPlan(family=kind, mode="bank", n=n,
                                    batched=True, device=DEVICE).program()
            bank_dev = rel_dev(yb, f32_bank_fn(
                table_arrays(basis.fwd), table_arrays(basis.bwd),
                lv.bank_gains, xs))
            check(bank_dev < 0.03, f"[main-bf16 {tag}] bank deviates "
                  f"{bank_dev:.4f} from the f32 bank")
            worst = (check_filters_dense(f"main-bf16 {tag}", eng, yb, xs,
                                         laps, rec["out"]["rel_error"])
                     if kind == "sym" else None)
            chain_entry = launcher.form(
                "batched_butterfly_apply" if kind == "sym"
                else "batched_shear_apply", "bf16")
            inv = basis.apply(xs, inverse=True, precision="bf16")
            err, scale = max_err(inv, basis.apply(
                xs, inverse=True, precision="bf16", backend="torch"))
            check(err <= tol * scale, f"[main-bf16 {tag}] apply vs plain "
                  f"max|dy| {err:.3e}")
            errs[chain_entry] = max(errs.get(chain_entry, 0.0), err)
            trip = rel_dev(yr, xs)
            check(bool(torch.isfinite(yr).all()) and trip < 0.03,
                  f"[main-bf16 {tag}] bf16 round trip deviates {trip:.4f}")
        f32_rates = {f"tier {t}": ts["transforms_per_s"]
                     for t, ts in rec["out"]["tiers"].items()}
        f32_rates["bank"] = f32_bank
        log(f"[main-bf16 {tag}] engine at bf16 on the fitted basis: full "
            f"tier vs the f32 engine relative deviation {dev:.3e}, bank "
            f"{bank_dev:.3e}; every tier and the bank vs plain within "
            f"{tol} * scale; apply round trip at bf16 vs x {trip:.3e}"
            + ("" if worst is None else f"; bank filters' worst error/bound "
               f"vs dense eigh {worst:.4f}"))
        log(f"[main-bf16 {tag}] rates at bf16 (f32): " + ", ".join(
            f"{k} {v:.1f} ({f32_rates[k]:.1f})" for k, v in rates.items())
            + " graph-transforms/s per tier, responses/s for the bank")
        engines[tag] = {"rates": rates, "f32_rates": f32_rates,
                        "full_dev": dev, "bank_dev": bank_dev,
                        "round_trip_dev": trip, "dense_worst": worst}

    # c. [main-ragged]'s saved router at bf16
    ckpt = ROOT / "build" / "ragged_checkpoint"
    router = driven(lambda: serve.RaggedFGFTServeEngine.load(
        ckpt, precision="bf16", device=DEVICE))
    check(all(e._live.fwd[2].dtype == torch.bfloat16
              for e in router.engines.values()),
          "the bf16 router does not serve bf16 tables")
    gen = torch.Generator(device=DEVICE).manual_seed(47)
    rsig = [torch.randn((64, n), generator=gen, device=DEVICE)
            for n in router.sizes]
    driven(lambda: router.step(rsig, lowpass))
    with uncounted():
        ragged_err = check_ragged_served("main-bf16 ragged", router, rsig,
                                         TOL)
        check_ragged_pads("main-bf16 ragged", router,
                          ragged_blocks(router, 53, 130), TOL, "bf16")

    # d. a dynamic engine at bf16, one forced REFRESH
    f32_eng = main["out"]["engine"]
    xs = main["out"]["signals"]
    stream = GraphStream([community_graph(MAIN["n"], seed=s)
                          for s in range(MAIN["graphs"])])
    check(np.array_equal(np.stack(stream.laplacians()), main["out"]["laps"]),
          "the stream differs from [main]'s Laplacians")
    deng = driven(lambda: serve.FGFTServeEngine(
        main["out"]["laps"], basis=f32_eng.basis, dynamic=True,
        tiers=serve.parse_tiers(MAIN["tiers"]), policy=RefitPolicy(),
        precision="bf16", device=DEVICE))
    driven(lambda: [deng.step(xs, lowpass, tier=t) for t in deng.tiers])
    cast = deng._live.fwd
    driven(lambda: update_round(deng, stream, DYNAMIC["forced_churn"], 7700))
    tick = driven(lambda: forced_tick("main-bf16 dynamic", deng, "refresh",
                                      refresh=0.5, extend=4.0, refit=8.0))
    check(deng.basis.fwd.c.dtype == torch.float32,
          "the dynamic engine's basis is not f32")
    check(deng._live.fwd[2] is cast[2], "REFRESH did not keep the bf16 cast")
    launcher.reset_stream_cache_counts()
    driven(lambda: [deng.step(xs, lowpass, tier=t) for t in deng.tiers])
    cache = launcher.stream_cache_counts()
    check(cache["misses"] == 0 and cache["hits"] == 2 * len(deng.tiers),
          f"[main-bf16 dynamic] steps after the REFRESH: stream cache "
          f"{cache}")
    with uncounted():
        lv = deng._live
        err, scale = max_err(deng.step(xs, lowpass), plain(
            "sym", "operator", MAIN["n"])(
                lv.fwd, lv.bwd, lowpass(lv.tiers[deng.default_tier][
                    "spectrum"]), xs))
        check(err <= TOL * scale, f"[main-bf16 dynamic] served full tier vs "
              f"plain max|dy| {err:.3e}")
    log(f"[main-bf16 dynamic] REFRESH on {table_shape(deng.basis)}: the "
        f"bf16 cast kept, steps after the swap hit the stream cache "
        f"{cache}; full tier vs plain max|dy| {err:.3e}")

    # e. the single-graph paths at bf16
    for tag, rec in (("single", single), ("single-directed", single_dir)):
        f, x0, g0 = rec["fgft"], rec["signals"], rec["gains"]
        bank = ApplyPlan(family=f.family, mode="bank", n=f.n,
                         precision="bf16", device=DEVICE)
        ys = driven(lambda: (f.synthesis(f.analysis(x0, precision="bf16"),
                                         precision="bf16"),
                             f.project(x0, lowpass, precision="bf16"),
                             bank.bank(f.fwd, f.bwd, g0, x0)))
        with uncounted():
            tol = TOL if f.family == "sym" else 0.0
            fam = "sym" if f.family == "sym" else "gen"
            wants = (f.synthesis(f.analysis(x0, "torch", precision="bf16"),
                                 "torch", precision="bf16"),
                     f.project(x0, lowpass, "torch", precision="bf16"),
                     ApplyPlan(family=f.family, mode="bank", n=f.n,
                               precision="bf16", backend="torch",
                               device=DEVICE).bank(f.fwd, f.bwd, g0, x0))
            names = ("butterfly_apply" if fam == "sym" else "shear_apply",
                     f"{fam}_operator_apply", f"{fam}_filter_bank_apply")
            for name, got, want in zip(names, ys, wants):
                err, scale = max_err(got, want)
                name = launcher.form(name, "bf16")
                check(err <= tol * scale, f"[main-bf16 {tag}] {name} vs "
                      f"plain max|dy| {err:.3e}")
                errs[name] = max(errs.get(name, 0.0), err)
        log(f"[main-bf16 {tag}] analysis, synthesis, project and bank at "
            f"bf16 vs plain within {tol} * scale")

    missing = [e for e in launcher.ENTRIES
               if counts[launcher.form(e, "bf16")] == 0]
    check(not missing, f"[main-bf16] bf16 forms never launched: {missing}")
    phase_s = time.perf_counter() - t_phase
    log(f"[main-bf16] {phase_s:.1f}s in all; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return {"launches": dict(counts), "wall_s": wall, "fit_s": out["fit_s"],
            "responses_per_s": out["responses_per_s"],
            "cli_dense_worst": cli_worst, "engines": engines,
            "ragged_served_err": ragged_err, "dynamic_tick": tick,
            "dynamic_cache": cache, "phase_s": phase_s}


#: entry point -> its plain version's name in kernels/ref.py
REF_OF = {"butterfly_apply": "staged_g_apply",
          "batched_butterfly_apply": "batched_g_apply",
          "shear_apply": "staged_t_apply",
          "batched_shear_apply": "batched_t_apply"}


def phase_main_bf16x(errs, main, filt, single, main_dir,
                     single_dir) -> dict:
    """[main-bf16x]: the main path on one bf16 signal block (R = 256) on
    the tables the earlier phases fitted (no fit), each part driven with
    the counts zeroed just before and read just after (comparisons not
    counted).  a. f32 tables, as a user's f32 engines and bases serve a
    bf16 block: [main]'s engine at every tier, [main-filter]'s bank
    (``step_bank``, F = 7) and its ``SpectralFilterBank.apply``, [main]'s
    basis ``apply`` (both ways) and ``project``, the single graph's
    ``FGFT.analysis``, ``synthesis``, ``filter`` and bank; the same for
    [main-directed] (its engine, its bank engine and basis) and
    [fgft-directed].  b. the same tables cast to bf16 through the 12
    entry points.  Every answer is bf16 and bitwise equal to its plain
    version on the same block; the engine's tiers equal ``project`` at
    the tier and its bank the basis's own bank.  The distance to the
    same block's f32 answer (max|dy| / max|y|) is printed, not gated:
    it is the bf16 semantics the JAX package chose.  Every bf16-signal
    form must have launched."""
    from collections import Counter
    import torch
    from repro_torch.kernels import butterfly as bf
    from repro_torch.kernels import launcher, ref
    from repro_torch.kernels import shear as sh
    from repro_torch.kernels import spectral as ksp
    from repro_torch.kernels.plan import ApplyPlan
    t_phase = time.perf_counter()
    counts: Counter = Counter()
    bf16 = torch.bfloat16
    dist: dict = {}

    def driven(fn):
        launcher.reset_launch_counts()
        out = fn()
        sync()
        counts.update(launcher.entry_launch_counts())
        return out

    def hold(tag, got, plain, f32=None):
        """got (a served bf16 answer) bitwise its plain version; the
        distance to the f32 answer into ``dist``."""
        check(got.dtype == bf16, f"[main-bf16x] {tag}: answer is "
              f"{got.dtype}")
        check(bool(torch.isfinite(got).all()), f"[main-bf16x] {tag}: "
              f"non-finite")
        check(torch.equal(got, plain), f"[main-bf16x] {tag}: max|dy| "
              f"{float((got.float() - plain.float()).abs().max()):.3e} "
              f"against the plain version (want 0)")
        if f32 is not None:
            dist[tag] = float((got.float() - f32).abs().max()
                              / f32.abs().max().clamp(min=1e-30))

    # a. f32 tables: the path as a user serves a bf16 block
    for family, rec, frec, srec in (
            ("sym", main, filt, single),
            ("general", main_dir, main_dir["bank"], single_dir)):
        fam = "G" if family == "sym" else "T"
        engine = rec["out"]["engine"]
        bank_engine = (frec["out"]["engine"] if family == "sym"
                       else frec["engine"])
        basis = engine.basis
        x32 = rec["out"]["signals"]
        x = x32.to(bf16)
        tiers = list(engine.tiers)
        ys = driven(lambda: [engine.step(x, lowpass, tier=t) for t in tiers])
        yb = driven(lambda: bank_engine.step_bank(x))
        ybank = driven(lambda: bank_engine.bank.apply(x))
        ya = driven(lambda: (basis.apply(x, inverse=True), basis.apply(x),
                             basis.project(x, h=lowpass)))
        f, x0_32 = srec["fgft"], srec["signals"]
        x0, g0 = x0_32.to(bf16), srec["gains"]
        sbank = ApplyPlan(family=f.family, mode="bank", n=f.n, device=DEVICE)
        y1 = driven(lambda: (f.analysis(x0), f.synthesis(x0),
                             f.filter(x0, lowpass),
                             sbank.bank(f.fwd, f.bwd, g0, x0)))
        with uncounted():
            for t, y in zip(tiers, ys):
                lt = engine._live.tiers[t]
                k = lt["num_stages"]
                h_t = (lambda spec: lambda _: lowpass(spec))(lt["spectrum"])
                hold(f"{fam} tier {t}", y,
                     basis.project(x, h=h_t, num_stages=k, backend="torch"),
                     engine.step(x32, lowpass, tier=t))
                check(torch.equal(y, basis.project(x, h=h_t, num_stages=k)),
                      f"[main-bf16x] {fam} tier {t} != project at the tier")
            bplain = bank_engine.bank.apply(x, backend="torch")
            hold(f"{fam} bank", yb, bplain, bank_engine.step_bank(x32))
            hold(f"{fam} SpectralFilterBank.apply", ybank, bplain)
            for name, y, want, w32 in zip(
                    ("apply inverse", "apply", "project"), ya,
                    (basis.apply(x, inverse=True, backend="torch"),
                     basis.apply(x, backend="torch"),
                     basis.project(x, h=lowpass, backend="torch")),
                    (basis.apply(x32, inverse=True), basis.apply(x32),
                     basis.project(x32, h=lowpass))):
                hold(f"{fam} {name}", y, want, w32)
            splain = ApplyPlan(family=f.family, mode="bank", n=f.n,
                               backend="torch", device=DEVICE)
            for name, y, want, w32 in zip(
                    ("FGFT.analysis", "FGFT.synthesis", "FGFT.filter",
                     "single bank"), y1,
                    (f.analysis(x0, "torch"), f.synthesis(x0, "torch"),
                     f.filter(x0, lowpass, "torch"),
                     splain.bank(f.fwd, f.bwd, g0, x0)),
                    (f.analysis(x0_32), f.synthesis(x0_32),
                     f.filter(x0_32, lowpass),
                     sbank.bank(f.fwd, f.bwd, g0, x0_32))):
                hold(f"{fam} {name}", y, want, w32)
        log(f"[main-bf16x] {fam} f32 tables, bf16 block {list(x.shape)}: "
            f"tiers {tiers}, bank, SpectralFilterBank.apply, apply, "
            f"project and the single graph's analysis, synthesis, filter "
            f"and bank: bf16, bitwise equal to the plain versions; tiers "
            f"equal project at the tier, the bank the basis's own bank")

    # b. the same tables cast to bf16, through the 12 entry points
    for family, rec, frec, srec in (
            ("sym", main, filt, single),
            ("general", main_dir, main_dir["bank"], single_dir)):
        fam = "G" if family == "sym" else "T"
        engine = rec["out"]["engine"]
        bank_engine = (frec["out"]["engine"] if family == "sym"
                       else frec["engine"])
        basis, bbasis = engine.basis, bank_engine.basis
        x = rec["out"]["signals"].to(bf16)
        fwd, bwd = at_precision("bf16", basis.fwd, basis.bwd)
        bfwd, bbwd = at_precision("bf16", bbasis.fwd, bbasis.bwd)
        f = srec["fgft"]
        sfwd, sbwd = at_precision("bf16", f.fwd, f.bwd)
        x0, g0 = srec["signals"].to(bf16), srec["gains"]
        gains = bank_engine._live.bank_gains
        spec = engine.tiers[engine.default_tier]["spectrum"]
        d, d0 = lowpass(spec), lowpass(f.spectrum)
        mod, pre = (bf, "sym") if family == "sym" else (sh, "gen")
        chain = "butterfly_apply" if family == "sym" else "shear_apply"
        calls = {
            f"batched_{chain}": (getattr(mod, f"batched_{chain}"),
                                 (fwd, x)),
            chain: (getattr(mod, chain), (sfwd, x0)),
            f"batched_{pre}_operator_apply": (
                getattr(mod, f"batched_{pre}_operator_apply"),
                (fwd, bwd, d, x)),
            f"{pre}_operator_apply": (getattr(mod, f"{pre}_operator_apply"),
                                      (sfwd, sbwd, d0, x0)),
            f"batched_{pre}_filter_bank_apply": (
                getattr(ksp, f"batched_{pre}_filter_bank_apply"),
                (bfwd, bbwd, gains, x)),
            f"{pre}_filter_bank_apply": (
                getattr(ksp, f"{pre}_filter_bank_apply"),
                (sfwd, sbwd, g0, x0)),
        }
        ys = driven(lambda: {e: fn(*a) for e, (fn, a) in calls.items()})
        with uncounted():
            for entry, (fn, args) in calls.items():
                plain = getattr(ref, REF_OF.get(entry, entry))
                hold(f"{fam} {entry} (bf16 tables)", ys[entry],
                     plain(*args))
        log(f"[main-bf16x] {fam} bf16 tables, bf16 blocks: the six entry "
            f"points bitwise equal to their plain versions")

    for tag, v in dist.items():
        log(f"[main-bf16x] {tag}: max|dy| / max|y| against the same block "
            f"in f32: {v:.4e}")
    missing = [launcher.form(e, p, "bf16") for e in launcher.ENTRIES
               for p in ("f32", "bf16")
               if counts[launcher.form(e, p, "bf16")] == 0]
    check(not missing, f"[main-bf16x] bf16-signal forms never launched: "
          f"{missing}")
    phase_s = time.perf_counter() - t_phase
    log(f"[main-bf16x] {phase_s:.1f}s in all; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return {"launches": dict(counts), "f32_distance": dist,
            "phase_s": phase_s}


#: [main-core]: the paper's baselines on the first graphs of [main]'s
#: fleet, a compressed square projection at the d_model of the narrowest
#: config in src/repro/configs/ (seamless-m4t-large-v2: 1024) over 4096
#: token rows, the butterfly layer and gradient compression at that width,
#: and the tile autotuner on [main]'s and [main-filter]'s plans.  The
#: projection's chains take g = 2048 (2n), not 4096: at 4096 its two
#: eager fits took 48-77 s of a run held to 1200 s; and one polish pass
#: (n_iter 2 took 32.4 s on a slow host)
CORE = dict(graphs=4, n=1024, g_orth=2048, g_sym=2048, n_iter=1,
            tokens=4096, layer_rows=1024, leaf=(1024, 4096), ratio=0.125,
            candidates=(32, 64, 128, 256), calls=3)


def rel_sq(a, b) -> float:
    """||a - b||^2 / ||b||^2 in float64."""
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).sum() / (b ** 2).sum())


def core_baselines(main) -> dict:
    """[main-core] a: truncated Jacobi, the greedy Givens factorization of
    the exact eigenvectors (Lemma-1 spectrum) and rank r at matched flops
    on the first CORE["graphs"] graphs of [main]'s fleet (each greedy
    method on the stack of them: one chain a graph, in lockstep), beside
    [main]'s fit; the greedy loops under
    ``torch.cuda.set_sync_debug_mode("error")``.  Each chain's dense U
    is its packed tables' chain kernel on the identity (held to the plain
    version by phase 2)."""
    import numpy as np
    import torch
    from repro_torch.core import (factorize_orthonormal, pack_g,
                                  rank_r_symmetric, truncated_jacobi)
    from repro_torch.core.types import GFactors
    from repro_torch.kernels import butterfly as bf
    basis = main["out"]["engine"].basis
    n, g = basis.n, basis.num_transforms
    r = max(3 * g // (2 * n), 1)
    laps = torch.as_tensor(np.asarray(main["out"]["laps"][:CORE["graphs"]]),
                           dtype=torch.float32).to(DEVICE)
    eye = torch.eye(n, device=DEVICE)
    # rows of Ubar applied to e_r are U's columns: U = (Ubar I)^T
    fitted = bf.batched_butterfly_apply(
        basis.fwd, eye.expand(basis.spectrum.shape[0], n, n).contiguous()
    ).transpose(1, 2)
    rows, secs = [], {"jacobi": 0.0, "givens": 0.0, "rank_r": 0.0}

    def timed(key, fn, *args, greedy=True):
        """fn(*args) timed; a greedy loop under the sync gate."""
        sync()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error" if greedy else 0)
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sync()
        secs[key] += time.perf_counter() - t0
        return out

    def dense(tag, factors):
        u = bf.butterfly_apply(pack_g(factors, n=n, device=DEVICE), eye).T
        dev = float((u.T @ u - eye).abs().max())
        check(dev <= 1e-4, f"[main-core] {tag}: max|U^T U - I| {dev:.3e}")
        return u, dev

    fj, spec_j = timed("jacobi", truncated_jacobi, laps, g)
    _, vecs = torch.linalg.eigh(laps.double())
    fg = timed("givens", factorize_orthonormal, vecs.float(), g)
    for b in range(laps.shape[0]):
        lap = laps[b]
        u = fitted[b]
        proposed = rel_sq(u @ torch.diag(basis.spectrum[b]) @ u.T, lap)
        uj, worst = dense(f"graph {b} Jacobi", GFactors(*(f[b] for f in fj)))
        dj = float((spec_j[b] - torch.diagonal(uj.T @ lap @ uj)).abs().max())
        check(dj <= 1e-4 * float(lap.abs().max()),
              f"[main-core] graph {b}: Jacobi spectrum vs diag(U^T L U) "
              f"max|d| {dj:.3e}")
        jac = rel_sq(uj @ torch.diag(spec_j[b]) @ uj.T, lap)
        ug, dev = dense(f"graph {b} Givens", GFactors(*(f[b] for f in fg)))
        worst = max(worst, dev)
        lemma1 = torch.diagonal(ug.T @ lap @ ug)
        giv = rel_sq(ug @ torch.diag(lemma1) @ ug.T, lap)
        approx, flops = timed("rank_r", rank_r_symmetric, lap, r,
                              greedy=False)
        rank = rel_sq(approx, lap)
        errs_b = {"proposed": proposed, "jacobi": jac, "givens": giv,
                  f"rank_{r}": rank}
        rows.append(errs_b)
        log(f"[main-core] graph {b} (n={n}, g={g}): relative error "
            + ", ".join(f"{k} {v:.6f}" for k, v in errs_b.items())
            + f"; best {min(errs_b, key=errs_b.get)}; max|U^T U - I| "
            f"{worst:.2e}, Jacobi spectrum vs diag(U^T L U) {dj:.2e}")
    means = {k: float(np.mean([row[k] for row in rows])) for k in rows[0]}
    log(f"[main-core] baselines on {len(rows)} graphs: mean relative error "
        + ", ".join(f"{k} {v:.6f}" for k, v in means.items())
        + f" (rank r = {r} at g = {g}: {flops} flops a matvec); seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
        + f" (the {len(rows)} greedy chains of each method in lockstep, "
        "rank r per graph); no host sync in the greedy loops")
    return {"rel_error": rows, "mean": means, "seconds": secs, "rank": r}


def synthetic_projection(n: int, seed: int):
    """A "trained" square projection with a decaying spectrum, built as
    examples/compress_projection.py builds one (spectrum exp(-k / (n/4)))."""
    import numpy as np
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.standard_normal((n, n)))[0]
    spectrum = np.exp(-np.arange(n) / (n / 4.0))
    w = (basis * spectrum[None, :]) @ np.linalg.qr(
        rng.standard_normal((n, n)))[0]
    return w.astype(np.float32)


def core_linear(errs, counts) -> dict:
    """[main-core] b: compress_linear at n = CORE["n"] and
    compressed_linear_apply over CORE["tokens"] rows: one operator and
    one chain launch a call, against its plain version and against x W^T
    through the dense factors."""
    import torch
    from repro_torch.core import (compress_linear, compressed_linear_apply,
                                  g_to_dense)
    from repro_torch.kernels import butterfly as bf
    from repro_torch.kernels import launcher, ref
    n = CORE["n"]
    w = torch.from_numpy(synthetic_projection(n, 0)).to(DEVICE)
    sync()
    t0 = time.perf_counter()
    comp, info = compress_linear(w, CORE["g_orth"], CORE["g_sym"],
                                 CORE["n_iter"])
    sync()
    fit_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    x = torch.randn((CORE["tokens"], n), generator=gen, device=DEVICE)
    launcher.reset_launch_counts()
    ys = [compressed_linear_apply(comp, x) for _ in range(CORE["calls"])]
    sync()
    got = launcher.entry_launch_counts()
    counts.update(got)
    launched = {k: v for k, v in got.items() if v}
    check(launched == {"sym_operator_apply": CORE["calls"],
                       "butterfly_apply": CORE["calls"]},
          f"[main-core] compressed_linear_apply x {CORE['calls']} "
          f"launched {launched}")
    y = ys[0]
    with uncounted():
        check(all(torch.equal(v, y) for v in ys[1:]),
              "[main-core] compressed_linear_apply is not deterministic")
        plain = compressed_linear_apply(comp, x, backend="torch")
        err, scale = max_err(y, plain)
        check(err <= TOL * scale, f"[main-core] compressed linear vs plain "
              f"max|dy| {err:.3e} > {TOL} * {scale:.3e}")
        h = ref.sym_operator_apply(comp.h_fwd, comp.h_adj, comp.diag,
                                   x).contiguous()
        compare("sym_operator_apply", bf.sym_operator_apply(
            comp.h_fwd, comp.h_adj, comp.diag, x), h, errs)
        compare("butterfly_apply", bf.butterfly_apply(comp.q_fwd, h),
                ref.staged_g_apply(comp.q_fwd, h), errs)
        qd, hd = (g_to_dense(_chain_of(t), n)
                  for t in (comp.q_fwd, comp.h_fwd))
        w_hat = qd @ (hd * comp.diag[None, :]) @ hd.T
        y_dense = x @ w_hat.T
        dense_dev = ((y - y_dense).norm() / y_dense.norm()).item()
        check(dense_dev <= 1e-4, f"[main-core] compressed linear vs x W^T "
              f"of the dense factors: relative {dense_dev:.3e}")
        app_err = rel_sq(y, x @ w.T)
        ms = time_ms(lambda: compressed_linear_apply(comp, x))
        plain_ms = time_ms(lambda: compressed_linear_apply(
            comp, x, backend="torch"), reps=1, rounds=3)
        mm_ms = time_ms(lambda: torch.matmul(x, w.T))
        op_ms = device_ms(lambda: compressed_linear_apply(comp, x),
                          "g_operator_kernel")
        ch_ms = device_ms(lambda: compressed_linear_apply(comp, x),
                          "g_chain_kernel")
    legs = [real_entries(comp.h_adj, None, "head"),
            real_entries(comp.h_fwd, None, "tail"),
            real_entries(comp.q_fwd, None, "head")]
    b_ms, b_by = bound_ms(x, legs, 1)
    geos = {e: launcher.launch_geometry(e, 1, CORE["tokens"], n)
            for e in ("sym_operator_apply", "butterfly_apply")}
    log(f"[main-core] compress_linear n={n} g_orth={CORE['g_orth']} "
        f"g_sym={CORE['g_sym']} n_iter={CORE['n_iter']}: {fit_s:.1f}s; "
        f"reported rel_err {info['rel_err']:.6f}, h_obj "
        f"{info['h_obj']:.6f}; stages Q {comp.q_fwd.idx_i.shape[0]}, H "
        f"{comp.h_fwd.idx_i.shape[0]} of {comp.h_fwd.idx_i.shape[1]} pairs")
    log(f"[main-core] compressed_linear_apply x [{CORE['tokens']}, {n}]: "
        f"||y - x W^T||^2 / ||x W^T||^2 {app_err:.6f} (rel_err "
        f"{info['rel_err']:.6f}); vs plain max|dy| {err:.3e} (scale "
        f"{scale:.3e}); vs x W_hat^T of the dense factors {dense_dev:.3e} "
        f"relative; launches {launched} for {CORE['calls']} calls")
    log(f"[time] compressed_linear_apply at [{CORE['tokens']}, {n}]: "
        f"{ms:.4f} ms a call (device: g_operator_kernel "
        f"{'not measured' if op_ms is None else f'{op_ms:.4f} ms'}, "
        f"g_chain_kernel "
        f"{'not measured' if ch_ms is None else f'{ch_ms:.4f} ms'}), "
        f"plain {plain_ms:.3f} ms, torch.matmul(x, W.T) {mm_ms:.4f} ms, "
        f"bound {b_ms:.5f} ms ({b_by}), real entries per leg {legs}")
    for entry, geo in geos.items():
        log(f"[main-core] {entry} geometry at B=1 R={CORE['tokens']} "
            f"n={n}: {geo}")
    return {"fit_s": fit_s, "rel_err": info["rel_err"],
            "apply_rel_err": app_err, "plain_err": err,
            "dense_dev": dense_dev, "ms": ms, "plain_ms": plain_ms,
            "matmul_ms": mm_ms, "operator_device_ms": op_ms,
            "chain_device_ms": ch_ms, "bound_ms": b_ms, "bound_by": b_by,
            "geometry": geos}


def _chain_of(staged):
    """The G chain of B = 1 tables in application order (the real
    entries stage by stage), to materialize with g_to_dense."""
    from repro_torch.core.types import GFactors
    real = staged.idx_i < staged.n
    return GFactors(*(t[real] for t in (staged.idx_i, staged.idx_j,
                                         staged.c, staged.s, staged.sigma)))


def core_layers() -> dict:
    """[main-core] c: the butterfly layer at n = CORE["n"] (forward and
    backward, against the same call on the CPU) and ef_roundtrip of a
    CORE["leaf"] leaf."""
    import torch
    from repro_torch.core import ButterflyParams, butterfly_apply, fft_pattern
    from repro_torch.core import butterfly_init
    from repro_torch.optim import compress
    n = CORE["n"]
    pat = fft_pattern(n, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(29)
    params = butterfly_init(gen, pat)
    # angles ~ N(0, 1) and a spread diagonal: with a constant diagonal
    # U diag(d) U^T would not depend on theta at all
    params = ButterflyParams(params.theta * 10.0, params.diag + torch.rand(
        (n,), generator=gen, device=DEVICE))
    x = torch.randn((CORE["layer_rows"], n), generator=gen, device=DEVICE)
    wgt = torch.randn((CORE["layer_rows"], n), generator=gen, device=DEVICE)
    mixed = butterfly_apply(params, pat, x, mix_only=True)
    norm_dev = float(((mixed.norm(dim=-1) - x.norm(dim=-1)).abs()
                      / x.norm(dim=-1)).max())
    check(norm_dev <= 1e-5, f"[main-core] butterfly mixing is not "
          f"orthonormal: max relative norm change {norm_dev:.3e}")

    def grads(device):
        theta = params.theta.to(device).clone().requires_grad_(True)
        diag = params.diag.to(device).clone().requires_grad_(True)
        xx = x.to(device).clone().requires_grad_(True)
        y = butterfly_apply(ButterflyParams(theta, diag),
                            pat._replace(idx_i=pat.idx_i.to(device),
                                         idx_j=pat.idx_j.to(device)), xx)
        ((wgt.to(device) * y).sum() + (y ** 2).sum()).backward()
        return [t.grad for t in (theta, diag, xx)]
    sync()
    t0 = time.perf_counter()
    on_card = grads(DEVICE)
    sync()
    layer_s = time.perf_counter() - t0
    on_cpu = grads("cpu")
    grad_dev = max(float((a.cpu() - b).abs().max() / b.abs().max())
                   for a, b in zip(on_card, on_cpu))
    check(grad_dev <= 1e-4, f"[main-core] butterfly gradients on the card "
          f"vs the CPU: {grad_dev:.3e} relative")
    log(f"[main-core] butterfly layer n={n} ({pat.idx_i.shape[0]} stages) "
        f"on [{CORE['layer_rows']}, {n}]: mixing norm change "
        f"{norm_dev:.2e}; forward + backward {layer_s:.3f}s; gradients "
        f"(theta, d, x) vs the CPU {grad_dev:.2e} relative")

    spec = compress.make_spec(n, CORE["ratio"], device=DEVICE)
    grad = torch.randn(CORE["leaf"], generator=gen, device=DEVICE)
    err = 0.1 * torch.randn(CORE["leaf"], generator=gen, device=DEVICE)
    sync()
    t0 = time.perf_counter()
    out, new_err = compress.ef_roundtrip(spec, grad, err, step=3)
    sync()
    ef_s = time.perf_counter() - t0
    want = grad + err
    split = float((out + new_err - want).abs().max() / want.abs().max())
    check(split <= 1e-5, f"[main-core] out + new_err != grad + err: "
          f"{split:.3e} relative")
    full = compress.make_spec(n, 1.0, device=DEVICE)
    out1, err1 = compress.ef_roundtrip(full, grad, err, step=3)
    ident = float((out1 - want).abs().max() / want.abs().max())
    check(ident <= 1e-5 and float(err1.abs().max()) <= 1e-5 * float(
        want.abs().max()), f"[main-core] ratio 1 is not the identity: "
        f"{ident:.3e}")
    kept = compress.compress(spec, grad).numel() / grad.numel()
    log(f"[main-core] ef_roundtrip of a {list(CORE['leaf'])} leaf at width "
        f"{n}, ratio {CORE['ratio']} (kept {kept:.4f} of the bytes): "
        f"{ef_s:.4f}s; out + new_err vs grad + err {split:.2e} relative; "
        f"ratio 1 vs identity {ident:.2e}")
    return {"layer_s": layer_s, "grad_dev": grad_dev, "norm_dev": norm_dev,
            "ef_s": ef_s, "ef_split": split, "ef_identity": ident}


def core_autotune(main, filt, single, main_dir, single_dir) -> dict:
    """[main-core] d: the 12 entry points (and the batched G operator's
    bf16-table and bf16-signal forms) bitwise equal to their block_b=None
    launches at every candidate; autotune_block_b on [main]'s batched G
    operator and chain plans and [main-filter]'s bank plan; a plan built
    after ``clear_plan_cache()`` launches the cached tile."""
    import os
    import torch
    from repro_torch import obs
    from repro_torch.kernels import autotune, launcher
    from repro_torch.kernels import butterfly as bf
    from repro_torch.kernels import shear as sh
    from repro_torch.kernels import spectral as ksp
    from repro_torch.kernels.plan import ApplyPlan, clear_plan_cache
    path = pathlib.Path(os.environ[autotune.CACHE_ENV])
    path.unlink(missing_ok=True)
    engine, fengine = main["out"]["engine"], filt["out"]["engine"]
    basis, fbasis = engine.basis, fengine.basis
    x = main["out"]["signals"]
    bsz, rows, n = x.shape
    spec = lowpass(basis.spectrum)
    gains = fengine._live.bank_gains
    f, fd = single["fgft"], single_dir["fgft"]
    dbasis = main_dir["out"]["engine"].basis
    dbank = main_dir["bank"]["engine"]
    xd, x0, x0d = main_dir["out"]["signals"], single["signals"], \
        single_dir["signals"]
    calls = {
        "batched_butterfly_apply": (bf.batched_butterfly_apply,
                                    (basis.fwd, x)),
        "butterfly_apply": (bf.butterfly_apply, (f.fwd, x0)),
        "batched_sym_operator_apply": (bf.batched_sym_operator_apply,
                                       (basis.fwd, basis.bwd, spec, x)),
        "sym_operator_apply": (bf.sym_operator_apply,
                               (f.fwd, f.bwd, lowpass(f.spectrum), x0)),
        "batched_shear_apply": (sh.batched_shear_apply, (dbasis.fwd, xd)),
        "shear_apply": (sh.shear_apply, (fd.fwd, x0d)),
        "batched_gen_operator_apply": (
            sh.batched_gen_operator_apply,
            (dbasis.fwd, dbasis.bwd, lowpass(dbasis.spectrum), xd)),
        "gen_operator_apply": (sh.gen_operator_apply,
                               (fd.fwd, fd.bwd, lowpass(fd.spectrum), x0d)),
        "batched_sym_filter_bank_apply": (
            ksp.batched_sym_filter_bank_apply,
            (fbasis.fwd, fbasis.bwd, gains, filt["out"]["signals"])),
        "sym_filter_bank_apply": (ksp.sym_filter_bank_apply,
                                  (f.fwd, f.bwd, single["gains"], x0)),
        "batched_gen_filter_bank_apply": (
            ksp.batched_gen_filter_bank_apply,
            (dbank.basis.fwd, dbank.basis.bwd, dbank._live.bank_gains, xd)),
        "gen_filter_bank_apply": (ksp.gen_filter_bank_apply,
                                  (fd.fwd, fd.bwd, single_dir["gains"],
                                   x0d)),
    }
    bf16 = at_precision("bf16", basis.fwd, basis.bwd)
    calls["batched_sym_operator_apply_bf16"] = (
        bf.batched_sym_operator_apply, (*bf16, spec, x))
    calls["batched_sym_operator_apply_xbf16"] = (
        bf.batched_sym_operator_apply,
        (basis.fwd, basis.bwd, spec, x.to(torch.bfloat16)))
    check(set(launcher.ENTRIES) <= set(calls), "[main-core] entries missing")
    with uncounted():
        base = {k: fn(*a) for k, (fn, a) in calls.items()}
        for cand in CORE["candidates"]:
            for k, (fn, a) in calls.items():
                y = fn(*a, block_b=cand)
                dy = float((y.float() - base[k].float()).abs().max())
                check(torch.equal(y, base[k]), f"[main-core] {k} at "
                      f"block_b={cand} != its block_b=None launch: max|dy| "
                      f"{dy:.3e}")
        sync()
    log(f"[main-core] {len(calls)} entry point forms at block_b in "
        f"{CORE['candidates']}: bitwise equal to their block_b=None "
        f"launches")

    eye = torch.eye(n, device=DEVICE).expand(bsz, n, n).contiguous()
    tuned = [
        (ApplyPlan(family="sym", mode="operator", n=n, batched=True,
                   device=DEVICE), (basis.fwd, basis.bwd), spec, x, 1),
        (ApplyPlan(family="sym", mode="apply", n=n, batched=True,
                   device=DEVICE), (basis.fwd,), None, eye, 1),
        (ApplyPlan(family="sym", mode="bank", n=n, batched=True,
                   device=DEVICE), (fbasis.fwd, fbasis.bwd), gains,
         filt["out"]["signals"], gains.shape[1]),
    ]
    counter = obs.counter("autotune_measurements_total")
    before = counter.value()
    chosen = {}
    with uncounted():
        for plan, tables, d, xin, filters in tuned:
            args = tuple(plan.prepare(t) for t in tables)
            args += (xin,) if d is None else (d, xin)
            t0 = time.perf_counter()
            best = autotune.autotune_block_b(plan, args,
                                             candidates=CORE["candidates"],
                                             path=path)
            tune_s = time.perf_counter() - t0
            key = autotune.plan_key(plan)
            entry = autotune.load_cache(path)["entries"][key]
            entry_pt = {"sym": {"operator": "batched_sym_operator_apply",
                                "apply": "batched_butterfly_apply",
                                "bank": "batched_sym_filter_bank_apply"}}[
                plan.family][plan.mode]
            slots = int(tables[0].idx_i.shape[-1])
            geos = {c: launcher.launch_geometry(entry_pt, bsz, rows, n,
                                                filters, slots, c)
                    for c in [None, *CORE["candidates"]]}
            chosen[key] = {"block_b": best, "timings_us":
                           entry["timings_us"], "seconds": tune_s}
            log(f"[main-core] autotune {key}: timings (us) "
                f"{entry['timings_us']} -> block_b {best} ({tune_s:.2f}s)")
            for c, geo in geos.items():
                log(f"[main-core]   {entry_pt} at block_b={c}: "
                    f"{geo['ctas']} CTAs of {geo['rows_per_cta']} rows x "
                    f"{geo['filters_per_cta']} filters, "
                    f"{geo['resident_per_sm']} resident per SM")
            # a plan built after the record launches the cached tile
            clear_plan_cache()
            seen = []
            real = (launcher._bank_geometry_on if plan.mode == "bank"
                    else launcher._operator_geometry_on)

            def spy(*a, _real=real):
                geo = _real(*a)
                seen.append((a[-1], geo))
                return geo
            name = real.__name__
            setattr(launcher, name, spy)
            try:
                plan.program()(*args)
                sync()
            finally:
                setattr(launcher, name, real)
            check(seen and all(b == best for b, _ in seen),
                  f"[main-core] {key}: the rebuilt plan launched "
                  f"block_b {[b for b, _ in seen]}, cached {best}")
            log(f"[main-core]   after clear_plan_cache() the plan launches "
                f"block_b={best}: {seen[-1][1]}")
    clear_plan_cache()
    path.unlink()       # later plans keep the launcher's own geometry
    rose = counter.value() - before
    check(rose == len(tuned), f"[main-core] autotune_measurements_total "
          f"rose by {rose}, want {len(tuned)}")
    log(f"[main-core] autotune_measurements_total rose by {rose:g}")
    return {"chosen": chosen, "forms_checked": len(calls)}


def phase_main_core(errs, main, filt, single, main_dir, single_dir) -> dict:
    """[main-core]: the baselines, the compressed linear, the butterfly
    layer and gradient compression, and the tile autotuner (CORE)."""
    from collections import Counter
    t_phase = time.perf_counter()
    counts: Counter = Counter()
    secs = {}
    t0 = time.perf_counter()
    base = core_baselines(main)
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    linear = core_linear(errs, counts)
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    layers = core_layers()
    secs["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tune = core_autotune(main, filt, single, main_dir, single_dir)
    secs["d"] = time.perf_counter() - t0
    phase_s = time.perf_counter() - t_phase
    log(f"[main-core] {phase_s:.1f}s in all (a {secs['a']:.1f}s, b "
        f"{secs['b']:.1f}s, c {secs['c']:.1f}s, d {secs['d']:.1f}s); "
        f"launches {dict((k, v) for k, v in counts.items() if v)}")
    return {"launches": dict(counts), "baselines": base, "linear": linear,
            "layers": layers, "autotune": tune, "phase_s": phase_s,
            "part_s": secs}


#: [main-lm]: the LM serving path (``serve --arch``) at full width, random
#: weights from seed 0 (no trained weights are in the repository): the CLI
#: at full depth, decode consistency of qwen2-1.5b (full depth) and of
#: gemma2-27b (full width, depth cut to 2 layers), slot-locality, the card
#: against the CPU (qwen2-1.5b at 2 layers, f32) and the chunked attention
#: path on a 2048-token prompt; bounds on logits as LM["tol"] x max(1,
#: max|logits|) per compute dtype
LM = dict(arch="qwen2-1.5b", wide="gemma2-27b", wide_layers=2, cpu_layers=2,
          requests=8, slots=4, prompt=32, gen=16, max_len=128,
          consistency=dict(batch=2, prompt=32, max_len=64),
          long_prompt=2048, chunk=1024,
          tol={"bfloat16": 2e-2, "float32": 1e-4})


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def lm_bound(logits, dtype) -> float:
    return LM["tol"][str(dtype).split(".")[-1]] * max(
        1.0, float(logits.float().abs().max()))


def lm_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def kernel_trace(fn, steps: int, host: bool = True) -> tuple:
    """Kernel launches and device-busy ms a call of ``fn`` (torch.profiler
    over ``steps`` calls, the kernel events of its Chrome trace; ``host``:
    the host's operator events traced too), and the calls' wall ms."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", dir=ROOT / "build")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    busy_us = sum(float(ev.get("dur", 0.0)) for ev in kernels)
    return (len(kernels) / steps, busy_us / 1e3 / steps,
            wall * 1e3 / steps)


def decode_kernels(engine, tokens, steps: int = 3) -> tuple:
    """Kernel launches and device ms a decode step (torch.profiler over
    ``steps`` steps), and the steps' wall ms."""
    return kernel_trace(lambda: engine.decode(tokens), steps)


def decode_bytes(engine) -> int:
    """Bytes a decode step of ``engine`` must move, each once: the weights
    its products and norms read (the compute-dtype copies, the LM head,
    the f32 norms and SSD/RG-LRU constants; of an MoE block the experts
    the step routed to), the memory a cross-attention block projects, the
    embedding rows it gathers, the cache it attends to and the entry it
    writes a slot and layer (a recurrent state: read and written whole),
    and the logits."""
    import torch
    from repro_torch.models import blocks as mb
    model, cfg, b = engine.model, engine.cfg, engine.b
    raw = {mb.SSDBlock: ("a_log", "d_skip"), mb.RGLRUBlock: ("lam",)}

    def nbytes(v) -> int:
        if isinstance(v, torch.Tensor):
            return v.numel() * v.element_size()
        if isinstance(v, tuple):
            return sum(nbytes(t) for t in v)
        return 0

    total = nbytes(model.c_lm_head) + nbytes(model.final_norm)
    for mod in model.modules():
        if isinstance(mod, mb.MoEBlock):
            experts = sum(nbytes(t) for t in (mod.c_gate, mod.c_up,
                                                mod.c_down))
            used = int(mod.routes.unique().numel())
            total += (nbytes(mod.norm) + nbytes(mod.c_router)
                      + experts * used // cfg.n_experts)
        elif isinstance(mod, (mb.AttnBlock, mb.MLPBlock, mb.CrossAttnBlock,
                              mb.SSDBlock, mb.RGLRUBlock)):
            total += nbytes(mod.norm) + sum(
                nbytes(v) for k, v in vars(mod).items() if k.startswith("c_"))
            total += sum(nbytes(getattr(mod, k)) for k in raw.get(type(mod),
                                                                  ()))
            if isinstance(mod, mb.CrossAttnBlock):
                total += nbytes(engine.memory)
    total += b * cfg.d_model * model.embed.element_size()
    stack = [engine.cache]
    while stack:
        for key, leaf in stack.pop().items():
            if isinstance(leaf, dict):
                stack.append(leaf)
            elif key in ("k", "v", "pos"):
                total += nbytes(leaf) + nbytes(leaf[:, :, 0])
            else:
                total += 2 * nbytes(leaf)
    total += b * cfg.vocab * torch.empty((), dtype=cfg.dtype).element_size()
    return total


def moe_drops(model) -> int:
    """Dropped (token, expert) pairs of the model's last call, summed
    over its MoE blocks."""
    from repro_torch.models.blocks import MoEBlock
    return sum(int((~m.kept).sum()) for m in model.modules()
               if isinstance(m, MoEBlock) and m.kept is not None)


def moe_kept(model) -> list:
    """Each MoE block's kept pairs of the last call (on the device)."""
    from repro_torch.models.blocks import MoEBlock
    return [m.kept for m in model.modules() if isinstance(m, MoEBlock)]


def moe_routes(model) -> list:
    """Each MoE block's top-k sets of the last call (expert ids sorted),
    on the host."""
    from repro_torch.models.blocks import MoEBlock
    return [m.routes.sort(-1).values.cpu() for m in model.modules()
            if isinstance(m, MoEBlock)]


def moe_token_routes(model) -> list:
    """Each MoE block's last call, per token in the call's B x S order:
    its top-k set (expert ids ascending) and which of those pairs were
    kept, on the host."""
    from repro_torch.models.blocks import MoEBlock
    out = []
    for m in model.modules():
        if isinstance(m, MoEBlock):
            k = m.routes.shape[-1]
            ids, order = m.routes.reshape(-1, k).sort(-1)
            out.append((ids.cpu(), m.kept.reshape(-1, k).gather(
                -1, order).cpu()))
    return out


def same_routes(a: list, i: int, b: list, j: int) -> bool:
    """Whether token i of one call (``moe_token_routes``) and token j of
    another have the same top-k sets and kept pairs in every block."""
    import torch
    return all(torch.equal(x[0][i], y[0][j]) and torch.equal(x[1][i], y[1][j])
               for x, y in zip(a, b))


def tree_leaves(tree):
    """The leaves of nested dicts."""
    for v in tree.values():
        yield from tree_leaves(v) if isinstance(v, dict) else (v,)


def lm_memory(cfg, b: int, s: int, seed: int):
    """A vision or audio request's memory as the JAX engine draws it
    (normal x 0.02; num_patches patches or max(S // enc_ratio, 1)
    frames), (b, P, d) f32 on the host; None for the other families."""
    import numpy as np
    if cfg.family == "vlm":
        shape = (b, cfg.num_patches, cfg.d_model)
    elif cfg.is_encdec:
        shape = (b, max(s // cfg.enc_ratio, 1), cfg.d_model)
    else:
        return None
    return np.random.default_rng(seed).standard_normal(
        shape, np.float32) * 0.02


def open_gates(tree, value: float):
    """Set a parameter tree's cross-attention gates to ``value`` (their
    init, 0, multiplies the memory's contribution by tanh(0) = 0)."""
    for grp in tree["groups"].values():
        if "cross" in grp:
            grp["cross"]["gate"].fill_(value)
    return tree


def decode_consistency(tag, model, card, cache_dtype=None, note: str = "",
                       prefix: str = "[main-lm]", memory=None) -> dict:
    """b: prefill + one decode against ``forward`` of the extended
    sequence (the JAX package's tests/test_models.py check), on
    ``memory`` where the family reads one.  An MoE model's dropped
    (token, expert) pairs are counted on each side.  ``gate_err``: what
    the gate holds: every row of a dense model; of a one-layer MoE model
    the rows whose compared token has the same top-k sets and kept pairs
    on both sides (its logits then read no other token's MoE output, so
    they differ by rounding alone); of a deeper one none."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as tfm
    cfg, c = model.cfg, LM["consistency"]
    b, s = c["batch"], c["prompt"]
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (b, s))
    kw = {} if cache_dtype is None else {"dtype": cache_dtype}
    cache = tfm.init_cache(cfg, b, c["max_len"], DEVICE, **kw)
    logits_p, cache, mem = model.prefill(cache, toks, memory)
    drops = {"prefill": moe_drops(model)}
    routes = {"prefill": moe_token_routes(model)}
    tok = logits_p[:, -1].argmax(-1)[:, None]
    logits_d, _ = model.decode_step(cache, tok, torch.full((b,), s), mem)
    drops["decode"] = moe_drops(model)
    routes["decode"] = moe_token_routes(model)
    logits_f = model.forward(np.concatenate([toks, tok.cpu().numpy()], 1),
                             memory)
    drops["forward"] = moe_drops(model)
    routes["forward"] = moe_token_routes(model)
    for t in (logits_p, logits_d, logits_f):
        check(bool(torch.isfinite(t.float()).all()),
              f"{prefix} b. {tag}: non-finite logits")
    bound = lm_bound(logits_f, cfg.dtype)
    err_p = lm_err(logits_f[:, s - 1], logits_p[:, 0])
    err_d = lm_err(logits_f[:, s], logits_d[:, 0])
    gated = [(err_p, b), (err_d, b)]
    cache_name = str((cache_dtype or torch.bfloat16)).split(".")[-1]
    if cfg.n_experts:
        gated = [(0.0, 0), (0.0, 0)]
        if cfg.n_layers == 1:   # rows whose compared token routes alike
            # (side, its logits, row i's token in its call, its position)
            sides = (("prefill", logits_p, lambda i: i * s + s - 1, s - 1),
                     ("decode", logits_d, lambda i: i, s))
            gated = []
            for side, got, at, pos in sides:
                rows = [i for i in range(b) if same_routes(
                    routes[side], at(i), routes["forward"],
                    i * (s + 1) + pos)]
                gated.append((max((lm_err(logits_f[i, pos], got[i, 0])
                                   for i in rows), default=0.0), len(rows)))
        note += (f"; dropped (token, expert) pairs: forward "
                 f"{drops['forward']}, prefill {drops['prefill']}, decode "
                 f"{drops['decode']} (forward, prefill and decode group the "
                 f"tokens differently, so capacity drops differ: "
                 + (f"gated on the rows whose compared token has the same "
                    f"top-k sets and kept pairs on both sides, prefill "
                    f"{gated[0][1]} of {b} at {gated[0][0]:.3e}, decode "
                    f"{gated[1][1]} of {b} at {gated[1][0]:.3e})"
                    if cfg.n_layers == 1 else "printed, not gated)"))
    depth = (f"{cfg.n_layers} layers" if not cfg.is_encdec else
             f"{cfg.n_enc_layers} + {cfg.n_layers} layers")
    log(f"{prefix} b. {tag} ({str(cfg.dtype).split('.')[-1]}, {depth}, "
        f"{cache_name} cache): prefill vs forward {err_p:.3e}, decode vs "
        f"forward {err_d:.3e}, bound {bound:.3e} (max|logits| "
        f"{float(logits_f.float().abs().max()):.4f}){note} [{card}]")
    return {"prefill": err_p, "decode": err_d, "bound": bound,
            "drops": drops, "gate_err": max(e for e, _ in gated),
            "gated_rows": [n for _, n in gated]}


def lm_card_vs_cpu(card, arch=None, layers=None, prefix="[main-lm]",
                   made_on="cpu", cache_dtypes=None, gate=None, cut=None,
                   tree=None, park=None) -> dict:
    """d: parameters made once (seed 0, on ``made_on``) and copied to the
    other device; prefill and two decodes on the card against the port on
    the CPU (f32, full width, ``layers`` layers; an encoder-decoder as
    many encoder layers).  ``cut``: further changes to the config (named
    in the line); ``tree``: that config's parameters already drawn on
    the card; ``park``: a ``HostPark`` the CPU's copy is made in (pinned:
    ~47 GB/s from the card, pageable ~1.8).  ``cache_dtypes``: the
    caches to run (default: bf16, printed, then f32, gated).  An MoE
    model's top-k sets are compared call by call: a call whose sets
    differ anywhere is printed and left out of the gate."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    arch, layers = arch or LM["arch"], layers or LM["cpu_layers"]
    cfg = get_config(arch).replace(n_layers=layers, dtype=torch.float32,
                                   **(cut or {}))
    if cfg.is_encdec:
        cfg = cfg.replace(n_enc_layers=layers)
    if tree is None:
        tree = tfm.init_params(cfg, torch.Generator(
            device=made_on).manual_seed(0), made_on)
    if gate is not None:
        open_gates(tree, gate)
    if park is not None:
        park.clear()
    on = {where: tfm.tree_map(lambda t: t.to(dev) if park is None
                              or where != "cpu" else park.park(t), tree)
          for where, dev in (("cpu", "cpu"), ("card", DEVICE))}
    del tree
    models = {where: tfm.Transformer(cfg, t) for where, t in on.items()}
    c = LM["consistency"]
    b, s = c["batch"], c["prompt"]
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (b, s + 2))
    memory = lm_memory(cfg, b, s, seed=3)
    out = {}
    for cache_dtype in cache_dtypes or (torch.bfloat16, torch.float32):
        got, routes = {}, {}
        for where, model in models.items():
            cache = tfm.init_cache(cfg, b, c["max_len"], model.device,
                                   dtype=cache_dtype)
            logits, cache, mem = model.prefill(cache, toks[:, :s], memory)
            seq, rts = [logits], [moe_routes(model)]
            for t in (s, s + 1):
                seq.append(model.decode_step(cache, toks[:, t:t + 1],
                                             torch.full((b,), t), mem)[0])
                rts.append(moe_routes(model))
            got[where] = [x.cpu() for x in seq]
            routes[where] = rts
        errs = [lm_err(g, w) for g, w in zip(got["card"], got["cpu"])]
        bound = max(lm_bound(w, cfg.dtype) for w in got["cpu"])
        differ = [sum(int((x != y).any(-1).sum()) for x, y in zip(rc, rp))
                  for rc, rp in zip(routes["card"], routes["cpu"])]
        agree = [e for e, d in zip(errs, differ) if not d]
        name = str(cache_dtype).split(".")[-1]
        # a bf16 cache rounds f32 K/V that the two devices computed an
        # ulp apart to entries a bf16 ulp apart now and then, and which
        # ones depends on each device's sum order: printed, gated in f32
        gated = cache_dtype == torch.float32
        moe = ""
        if cfg.n_experts:
            moe = (f"; top-k sets that differ, per call: {differ}"
                   + ("" if not any(differ) else
                      f" (the gate covers the {len(agree)} of "
                      f"{len(errs)} calls whose sets all agree)"))
        log(f"{prefix} d. {arch} (f32, {layers} layers"
            f"{' + ' + str(layers) + ' encoder' if cfg.is_encdec else ''}"
            + "".join(f", {k} {dtype_name(v) if k.endswith('dtype') else v}"
                      for k, v in (cut or {}).items())
            + f", {name} cache) card vs CPU: prefill {errs[0]:.3e}, decode "
            f"{max(errs[1:]):.3e}, bound {bound:.3e}{moe}"
            f"{'' if gated else ' (printed, not gated)'} [{card}]")
        if gated:
            check(max(agree, default=0.0) <= bound, f"{prefix} d. {arch} "
                  f"card vs CPU {max(agree, default=0.0):.3e} > {bound:.3e}")
        out[name] = {"errs": errs, "bound": bound, "routes_differ": differ}
    return out


def lm_cli(prefix: str, arch: str, card) -> dict:
    """a: ``serve --arch ARCH`` at the full config through ``serve.main``
    (LM's requests, slots, prompt, generation and cache lengths): the
    served line, every token in [0, vocab); tokens/s, prefill and decode
    ms, ``max_memory_allocated``, and a decode step's kernel launches and
    device-busy ms beside its bytes bound.  Returns ``serve_lm``'s
    result."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", arch, "--requests", str(LM["requests"]),
            "--batch-slots", str(LM["slots"]), "--prompt-len",
            str(LM["prompt"]), "--gen-len", str(LM["gen"]), "--max-len",
            str(LM["max_len"])]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = serve.main(argv)
    sys.stdout.write(printed.getvalue())
    check(f"served {LM['requests']} requests, {LM['requests'] * LM['gen']} "
          f"tokens, " in printed.getvalue(), f"{prefix} a. no served line")
    peak = torch.cuda.max_memory_allocated()
    engine = out["engine"]
    cfg = engine.cfg
    toks = out["outputs"]
    check(sorted(toks) == list(range(LM["requests"]))
          and all(len(t) == LM["gen"] for t in toks.values())
          and out["tokens"] == LM["requests"] * LM["gen"],
          f"{prefix} a. served {out['tokens']} tokens, want "
          f"{LM['requests']} x {LM['gen']}")
    check(all(0 <= x < cfg.vocab for t in toks.values() for x in t),
          f"{prefix} a. a token outside [0, vocab)")
    n_kernels, busy_ms, wall_ms = decode_kernels(
        engine, np.zeros(LM["slots"], np.int32))
    step_bytes = decode_bytes(engine)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    pre = statistics.median(out["prefill_s"]) * 1e3
    dec = statistics.median(out["decode_s"]) * 1e3
    log(f"{prefix} a. serve {' '.join(argv)}: {out['tokens']} tokens in "
        f"{out['seconds']:.3f}s, {out['tokens'] / out['seconds']:.1f} tok/s; "
        f"prefill {pre:.2f} ms a request (median of "
        f"{len(out['prefill_s'])}), decode {dec:.2f} ms a step (median of "
        f"{len(out['decode_s'])}, first {out['decode_s'][0] * 1e3:.2f}); "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB [{card}]")
    log(f"{prefix} a. decode step ({LM['slots']} slots, {cfg.n_layers} "
        f"layers): {n_kernels:.0f} kernel launches, device busy "
        f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall (torch.profiler), "
        f"bound {bound_ms:.4f} ms ({step_bytes / 1e9:.3f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s: reckoned from the shapes, "
        f"not measured) [{card}]")
    return {**out, "peak": peak, "launches_a_step": n_kernels,
            "busy_ms": busy_ms, "wall_ms": wall_ms, "bound_ms": bound_ms}


def phase_main_lm(card) -> dict:
    """[main-lm]: the LM serving path (LM)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launcher
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    secs = {}
    launcher.reset_launch_counts()

    # a. the CLI at full config and full depth
    t0 = time.perf_counter()
    out = lm_cli("[main-lm]", LM["arch"], card)
    engine = out["engine"]
    cfg = engine.cfg
    toks = out["outputs"]
    prompts = out["prompts"]
    tree = tfm.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        0), DEVICE)
    check(torch.equal(tree["lm_head"], engine.model.lm_head),
          "[main-lm] the seed-0 parameters differ from the CLI engine's")
    del engine, out
    torch.cuda.empty_cache()
    secs["a"] = time.perf_counter() - t0

    # c. slot-locality: each request of a 4-slot run against the same
    # request alone in a 1-slot engine, fed the same tokens
    t0 = time.perf_counter()
    model = tfm.Transformer(cfg, tree)
    seen: dict = {}

    def on_logits(rid, logits):
        seen.setdefault(rid, []).append(logits.clone())

    slots = serve.run_requests(
        serve.ServeEngine(cfg, LM["slots"], LM["max_len"], model=model),
        prompts, LM["gen"], on_logits=on_logits)["outputs"]
    alone = serve.ServeEngine(cfg, 1, LM["max_len"], model=model)
    worst, agree, total = 0.0, 0, 0
    for rid, prompt in enumerate(prompts):
        alone.prefill_slot(0, prompt)
        got = [alone.logits[0].clone()]
        for step in range(1, LM["gen"]):
            alone.decode(np.array([slots[rid][step - 1]], np.int32))
            got.append(alone.logits[0].clone())
        for step, (g, w) in enumerate(zip(got, seen[rid])):
            err, bound = lm_err(g, w), lm_bound(w, cfg.dtype)
            check(err <= bound, f"[main-lm] c. request {rid} step {step}: "
                  f"{err:.3e} > {bound:.3e}")
            worst = max(worst, err / bound)
            agree += int(g.argmax()) == slots[rid][step]
            total += 1
    log(f"[main-lm] c. {LM['requests']} requests x {LM['gen']} steps in "
        f"{LM['slots']} slots vs each alone in 1 slot: largest |dlogits| "
        f"{worst:.3f} of the bound; {agree} of {total} greedy tokens agree; "
        f"the 4-slot run's tokens equal the CLI's: {slots == toks} [{card}]")
    secs["c"] = time.perf_counter() - t0

    # b. decode consistency at full width, bf16 and f32
    t0 = time.perf_counter()
    cons = {"bf16": decode_consistency(LM["arch"], model, card)}
    # e. the chunked attention path: a 2048-token prompt, two KV chunks
    # with skipping, against attn_impl="naive"; gated in f32, where the
    # two orders of the same sums agree to rounding, and printed in bf16,
    # where the two paths round the attention output in different places
    # at every layer
    t1 = time.perf_counter()
    check(cfg.attn_impl == "chunked" and cfg.attn_chunk == LM["chunk"]
          and cfg.attn_skip, "[main-lm] e. not the chunked config")
    long = np.random.default_rng(5).integers(0, cfg.vocab,
                                             (1, LM["long_prompt"]))
    f32 = tfm.Transformer(cfg.replace(dtype=torch.float32), tree)
    res_e = {}
    for name, m in (("bf16", model), ("f32", f32)):
        naive = tfm.Transformer(m.cfg.replace(attn_impl="naive"), tree)
        got = [x.prefill(tfm.init_cache(cfg, 1, LM["long_prompt"], DEVICE),
                         long)[0] for x in (m, naive)]
        del naive
        err, bound = lm_err(*got), lm_bound(got[1], m.cfg.dtype)
        gated = name == "f32"
        res_e[name] = {"err": err, "bound": bound}
        log(f"[main-lm] e. {LM['arch']} ({name}, {cfg.n_layers} layers) "
            f"prefill of {LM['long_prompt']} tokens, chunked (chunk "
            f"{cfg.attn_chunk}, skip) vs naive: {err:.3e}, bound "
            f"{bound:.3e}{'' if gated else ' (printed, not gated)'} "
            f"[{card}]")
        if gated:
            check(err <= bound, f"[main-lm] e. chunked vs naive {err:.3e} "
                  f"> {bound:.3e}")
    secs["e"] = time.perf_counter() - t1
    cons["f32"] = decode_consistency(LM["arch"], f32, card, torch.float32)
    cons["f32_bf16_cache"] = decode_consistency(
        LM["arch"], f32, card, note=" (printed, not gated: the bf16 cache "
        "the JAX package keeps at every dtype)")
    del model, f32, tree
    torch.cuda.empty_cache()
    wide = get_config(LM["wide"]).replace(n_layers=LM["wide_layers"])
    tree = tfm.init_params(wide, torch.Generator(device=DEVICE).manual_seed(
        0), DEVICE)
    cons["wide_bf16"] = decode_consistency(
        LM["wide"], tfm.Transformer(wide, tree), card)
    cons["wide_f32"] = decode_consistency(
        LM["wide"], tfm.Transformer(wide.replace(dtype=torch.float32), tree),
        card, torch.float32)
    del tree
    torch.cuda.empty_cache()
    for key in ("bf16", "f32", "wide_bf16", "wide_f32"):
        rec = cons[key]
        check(max(rec["prefill"], rec["decode"]) <= rec["bound"],
              f"[main-lm] b. {key}: {rec} over the bound")
    secs["b"] = time.perf_counter() - t0 - secs["e"]

    # d. card against CPU
    t0 = time.perf_counter()
    cpu = lm_card_vs_cpu(card)
    secs["d"] = time.perf_counter() - t0
    launches = launcher.entry_launch_counts()
    check(not any(launches.values()), f"[main-lm] launched {launches}")
    phase_s = time.perf_counter() - t_phase
    log(f"[main-lm] {phase_s:.1f}s in all (a {secs['a']:.1f}s, b "
        f"{secs['b']:.1f}s, c {secs['c']:.1f}s, d {secs['d']:.1f}s, e "
        f"{secs['e']:.1f}s); none of the 12 entry points launched [{card}]")
    return {"launches": launches, "consistency": cons, "cpu": cpu,
            "chunked": res_e, "phase_s": phase_s, "part_s": secs}


#: [main-lm-families]: the MoE, SSM, hybrid, vision and audio families'
#: serving path at their configs' full widths, random weights from seed 0
#: (the JAX distributions; no trained weights are in the repository) with
#: the cross-attention gates set to ``gate`` (their init, 0, multiplies
#: the memory's contribution by 0).  ``depth``: layers on the card (None:
#: the config's own); ``cpu_depth``: layers of the card-vs-CPU check (an
#: encoder-decoder as many encoder layers; recurrentgemma 3 = one full
#: rrl super-layer: at 2 its rrl group is empty); ``dual``: the
#: recurrences' chunked/scan prefill against single-token decodes.
LMF = dict(cli=("mamba2-780m", "recurrentgemma-2b"),
           depth={"mamba2-780m": None, "recurrentgemma-2b": None,
                  "seamless-m4t-large-v2": None, "qwen3-moe-30b-a3b": 2,
                  "llama-3.2-vision-90b": 5},
           cpu_depth={"mamba2-780m": 2, "recurrentgemma-2b": 3,
                      "seamless-m4t-large-v2": 2, "qwen3-moe-30b-a3b": 2,
                      "llama-3.2-vision-90b": 5},
           dual=("mamba2-780m", "recurrentgemma-2b"), dual_layers=2,
           dual_tokens=256, requests=4, gen=6, gate=1.0)


def lm_slot_locality(prefix, tag, model, card, gated: bool) -> dict:
    """c: LMF's requests of LM's prompt length through a 4-slot engine
    (memory drawn by the JAX engine's rule from a seeded rng), each
    request's logits at every step against the request alone in a 1-slot
    engine fed the same tokens and the same memory."""
    import numpy as np
    from repro_torch.launch import serve
    cfg = model.cfg
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, LM["prompt"]).astype(np.int32)
               for _ in range(LMF["requests"])]
    engine = serve.ServeEngine(cfg, LM["slots"], LM["max_len"], model=model)
    seen: dict = {}
    memories: dict = {}

    def on_logits(rid, logits):
        if rid not in seen:
            memories[rid] = engine.memory_in
        seen.setdefault(rid, []).append(logits.clone())

    outs = serve.run_requests(engine, prompts, LMF["gen"], rng,
                              on_logits=on_logits)["outputs"]
    del engine
    alone = serve.ServeEngine(cfg, 1, LM["max_len"], model=model)
    worst, agree, total = 0.0, 0, 0
    for rid, prompt in enumerate(prompts):
        alone.prefill_slot(0, prompt, memory=memories[rid])
        got = [alone.logits[0].clone()]
        for step in range(1, LMF["gen"]):
            alone.decode(np.array([outs[rid][step - 1]], np.int32))
            got.append(alone.logits[0].clone())
        for step, (g, w) in enumerate(zip(got, seen[rid])):
            err, bound = lm_err(g, w), lm_bound(w, cfg.dtype)
            if gated:
                check(err <= bound, f"{prefix} c. {tag} request {rid} step "
                      f"{step}: {err:.3e} > {bound:.3e}")
            worst = max(worst, err / bound)
            agree += int(g.argmax()) == outs[rid][step]
            total += 1
    log(f"{prefix} c. {tag}: {LMF['requests']} requests x {LMF['gen']} "
        f"steps in {LM['slots']} slots vs each alone in 1 slot"
        f"{', each on its own memory' if memories[0] is not None else ''}: "
        f"largest |dlogits| {worst:.3f} of the bound; {agree} of {total} "
        f"greedy tokens agree"
        f"{'' if gated else ' (printed, not gated: in the JAX semantics capacity couples the slots of a decode step)'}"
        f" [{card}]")
    return {"worst": worst, "agree": agree, "total": total, "gated": gated}


def lm_duality(prefix, arch, card) -> dict:
    """e: at full width, LMF's dual_layers layers, f32 with an f32 cache:
    the logits of a dual_tokens-token ``forward`` (chunked SSD / scanned
    RG-LRU) against dual_tokens single-token decode steps from an empty
    cache, and the cache a prefill of the same tokens leaves against the
    one the decode steps leave."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    cfg = get_config(arch).replace(n_layers=LMF["dual_layers"],
                                   dtype=torch.float32)
    model = tfm.Transformer(cfg, tfm.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE))
    n = LMF["dual_tokens"]
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (1, n))
    logits_f = model.forward(toks)
    prefilled = tfm.init_cache(cfg, 1, n, DEVICE, dtype=torch.float32)
    model.prefill(prefilled, toks)
    stepped = tfm.init_cache(cfg, 1, n, DEVICE, dtype=torch.float32)
    logits_d = torch.cat([model.decode_step(stepped, toks[:, t:t + 1],
                                            torch.full((1,), t))[0]
                          for t in range(n)], dim=1)
    err, bound = lm_err(logits_d, logits_f), lm_bound(logits_f, cfg.dtype)
    def states(cache):   # (a group of no layers holds empty tensors)
        return [t for grp in cache.values() for blk in grp.values()
                for k, t in blk.items()
                if k in ("state", "h", "conv") and t.numel()]

    flat_p, flat_d = states(prefilled), states(stepped)
    check(len(flat_p) > 0, f"{prefix} e. {arch}: no recurrent state")
    state = max(lm_err(p, d) / max(1.0, float(p.abs().max()))
                for p, d in zip(flat_p, flat_d))
    log(f"{prefix} e. {arch} (f32, {cfg.n_layers} layers, f32 cache): "
        f"forward of {n} tokens ({'chunked SSD, chunk ' + str(cfg.ssm_chunk) if cfg.ssm_state else 'Hillis-Steele RG-LRU scan'}) "
        f"vs {n} single-token decode steps: max|dlogits| {err:.3e}, bound "
        f"{bound:.3e}; prefill's states vs the steps', max|d| / max(1, "
        f"max|state|) {state:.3e} (bound 1e-4) [{card}]")
    check(err <= bound and state <= LM["tol"]["float32"],
          f"{prefix} e. {arch}: logits {err:.3e} (bound {bound:.3e}), "
          f"states {state:.3e}")
    return {"err": err, "bound": bound, "state": state}


#: kimi-k2-1t-a32b on the card (ROADMAP A6e): one layer at the config's
#: full width (d 7168, 64 heads, 8 KV heads, vocabulary 163840, 384
#: experts of ff 2048, top-8), seed-0 weights.  ``experts``: the named
#: cuts of the parts that cannot hold all 384 experts: ``f32``, the f32
#: checks (at 384 the f32 compute copies alone would add 77.6 GB to the
#: 38.8 GB of bf16 parameters), and ``train``, the recipe's bf16 step
#: (parameters, gradients and two bf16 moments at 8 B a parameter, plus
#: AdamW's f32 transients on the 1.17 B-entry embedding); ``step``: that
#: step's batch and steps (PERF.md §4).
KIMI = dict(arch="kimi-k2-1t-a32b", layers=1,
            experts=dict(f32=16, train=64),
            step=dict(batch=8, seq=256, steps=2))


def kimi_config(experts=None, f32: bool = False):
    """KIMI's config: the recipe's (bf16 parameters and compute) at one
    layer, with ``experts`` experts (None: all 384); ``f32``: f32
    parameters and compute."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(KIMI["arch"]).replace(n_layers=KIMI["layers"])
    if experts is not None:
        cfg = cfg.replace(n_experts=experts)
    if f32:
        cfg = cfg.replace(dtype=torch.float32, param_dtype=torch.float32)
    return cfg


def leaf_shapes(cfg) -> list:
    """The shapes of ``cfg``'s parameter leaves."""
    from repro_torch.models import transformer as tfm
    return [leaf.shape for leaf in tree_leaves(tfm.param_spec(cfg))]


def reckoned_params(cfg) -> dict:
    """The memory arithmetic of ``cfg``'s parameters, from the shapes
    alone: their count, their bytes at the parameter dtype, the largest
    leaf, and the peak of drawing them (``init_params`` draws each leaf
    in f32 and then casts it: every leaf drawn before it, the f32 draw
    and its cast)."""
    import math
    import torch
    from repro_torch.models import transformer as tfm
    size = torch.empty((), dtype=cfg.param_dtype).element_size()
    held = peak = largest = count = 0
    leaves = list(tree_leaves(tfm.param_spec(cfg)))
    for leaf in leaves:
        n = math.prod(leaf.shape)
        draw = (4 * n + (n * size if size != 4 else 0)
                if leaf.init == "normal" else n * size)
        peak = max(peak, held + draw)
        held += n * size
        largest, count = max(largest, n), count + n
    return {"params": count, "bytes": held, "largest": largest,
            "draw_peak": peak, "leaves": len(leaves)}


def kimi_decode(prefix, model, card) -> dict:
    """A 4-slot decode step of the kimi model: ms a step (host clock to
    the step's token read), its kernel launches and device-busy ms
    (torch.profiler), its bytes bound (``decode_bytes``: of the experts,
    those the step routed to), and the bytes of expert weights the
    dispatch reads: every expert's, since its (experts, capacity) table
    is run whole."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.blocks import MoEBlock, moe_groups
    cfg = model.cfg
    engine = serve.ServeEngine(cfg, LM["slots"], LM["max_len"], model=model)
    rng = np.random.default_rng(8)
    for slot in range(engine.b):
        engine.prefill_slot(slot, rng.integers(0, cfg.vocab, LM["prompt"]))
    toks = np.zeros(engine.b, np.int32)
    engine.decode(toks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        engine.decode(toks)
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    n_kernels, busy_ms, wall_ms = decode_kernels(engine, toks)
    step_bytes = decode_bytes(engine)
    moe = [m for m in model.modules() if isinstance(m, MoEBlock)]
    experts = sum(t.numel() * t.element_size() for m in moe
                  for t in (m.c_gate, m.c_up, m.c_down))
    used = sorted({int(e) for m in moe for e in m.routes.unique()})
    gsz, cap = moe_groups(cfg, engine.b, 1)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    read_ms = (step_bytes + experts * (1 - len(used) / cfg.n_experts)
               ) / HBM_BYTES_PER_S * 1e3
    log(f"{prefix} b. {cfg.name} decode step ({engine.b} slots, "
        f"{cfg.n_layers} layer): {step_ms:.3f} ms a step (host clock, "
        f"mean of 3), {n_kernels:.0f} kernel launches, device busy "
        f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall (torch.profiler); bound "
        f"{bound_ms:.4f} ms ({step_bytes / 1e9:.3f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, the {len(used)} routed "
        f"experts of {cfg.n_experts}: reckoned, not measured); the "
        f"dispatch reads every expert's weights each decode step "
        f"({experts / 1e9:.3f} GB: a group of {gsz} tokens at capacity "
        f"{cap} runs the whole (experts, capacity) table), "
        f"{read_ms:.4f} ms at that rate [{card}]")
    del engine
    return {"step_ms": step_ms, "launches_a_step": n_kernels,
            "busy_ms": busy_ms, "wall_ms": wall_ms, "bound_ms": bound_ms,
            "bytes": step_bytes, "expert_bytes": experts,
            "routed": len(used), "read_ms": read_ms}


def kimi_serving(prefix, card, secs, park=None) -> dict:
    """[main-lm-families]' kimi-k2 rows (KIMI), each part's seconds added
    to ``secs``: b (decode against forward, bf16) and c (slot locality)
    at all 384 experts in the recipe's bf16 parameters, read by the
    products as they lie (a bf16 model's compute copies are the
    parameters: checked, no byte allocated), the decode step's ms,
    launches, busy ms and bytes, printed, not gated (capacity drops
    differ: at a decode step's group capacity is 1); then one f32 draw at
    KIMI's f32 cut for b in f32 (gated per token where the routes agree)
    and d (card against CPU, f32 cache; ``park``: its host copy's
    pinned block)."""
    import torch
    from repro_torch.models import transformer as tfm
    arch = KIMI["arch"]
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = kimi_config()
    want = reckoned_params(cfg)
    tree = tfm.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        0), DEVICE)
    drawn = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    model = tfm.Transformer(cfg, tree)
    copies = torch.cuda.memory_allocated() - base - held
    log(f"{prefix} {arch}: {cfg.n_layers} layer at full width (d "
        f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.n_experts} experts, top "
        f"{cfg.top_k}), {want['params']} parameters in "
        f"{dtype_name(cfg.param_dtype)} (the recipe's), computed in "
        f"{dtype_name(cfg.dtype)}: held {held / 1e9:.3f} GB against "
        f"{want['bytes'] / 1e9:.3f} GB reckoned; the draw's peak "
        f"{drawn / 1e9:.3f} GB against {want['draw_peak'] / 1e9:.3f} GB "
        f"reckoned (each leaf drawn in f32, the largest "
        f"{want['largest'] * 4 / 1e9:.3f} GB, then cast); the compute "
        f"copies took {copies} B (they are the parameters) [{card}]")
    # the allocator rounds each leaf up to 512 B; a second copy of the
    # weights would take ~38.8 GB
    check(0 <= held - want["bytes"] <= 512 * want["leaves"]
          and copies < 2 ** 20, f"{prefix} {arch}: held {held} B (want "
          f"{want['bytes']}), copies {copies} B")
    cons = {"bf16": decode_consistency(arch, model, card, prefix=prefix)}
    dec = kimi_decode(prefix, model, card)
    secs["b"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    slots = lm_slot_locality(prefix, arch, model, card, gated=False)
    peak = torch.cuda.max_memory_allocated() - base
    log(f"{prefix} {arch}: max_memory_allocated {peak / 1e9:.3f} GB above "
        f"the {base / 1e9:.3f} GB held before (b and c: parameters, "
        f"caches, activations) [{card}]")
    del model, tree
    torch.cuda.empty_cache()
    secs["c"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    e = KIMI["experts"]["f32"]
    cfg32 = kimi_config(e, f32=True)
    tree = tfm.init_params(cfg32, torch.Generator(
        device=DEVICE).manual_seed(0), DEVICE)
    cons["f32"] = decode_consistency(f"{arch} at {e} experts", tfm.Transformer(
        cfg32, tree), card, torch.float32, prefix=prefix)
    secs["b"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = lm_card_vs_cpu(card, arch, KIMI["layers"], prefix, made_on=DEVICE,
                         cache_dtypes=(torch.float32,),
                         cut=dict(n_experts=e, param_dtype=torch.float32),
                         tree=tree, park=park)
    f32_peak = torch.cuda.max_memory_allocated() - base
    log(f"{prefix} {arch} at {e} experts (f32): {reckoned_params(cfg32)['params']} "
        f"parameters, {reckoned_params(cfg32)['bytes'] / 1e9:.3f} GB "
        f"reckoned (and as much again on the host for d); "
        f"max_memory_allocated {f32_peak / 1e9:.3f} GB above the "
        f"{base / 1e9:.3f} GB held before [{card}]")
    del tree
    torch.cuda.empty_cache()
    secs["d"] += time.perf_counter() - t0
    for key, rec in cons.items():
        check(rec["gate_err"] <= rec["bound"],
              f"{prefix} b. {arch} {key}: {rec} over the bound")
    return {"consistency": cons, "decode": dec, "slots": slots, "cpu": cpu,
            "reckoned": want, "held": held, "draw_peak": drawn,
            "peak": peak, "f32_peak": f32_peak}


def phase_main_lm_families(card) -> dict:
    """[main-lm-families]: the serving path of the MoE, SSM, hybrid,
    vision and audio families (LMF)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launcher
    from repro_torch.models import transformer as tfm
    prefix = "[main-lm-families]"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    secs = {k: 0.0 for k in "abcde"}
    launcher.reset_launch_counts()

    # a. the CLI at full config and full depth
    cli = {}
    for arch in LMF["cli"]:
        t0 = time.perf_counter()
        out = lm_cli(prefix, arch, card)
        cli[arch] = {k: out[k] for k in ("seconds", "tokens", "peak",
                                         "launches_a_step", "busy_ms",
                                         "wall_ms", "bound_ms")}
        lm_head = out["engine"].model.lm_head
        del out
        # b and c rebuild the model from seed 0: the CLI engine's weights
        tree = tfm.init_params(get_config(arch), torch.Generator(
            device=DEVICE).manual_seed(0), DEVICE)
        check(torch.equal(tree["lm_head"], lm_head), f"{prefix} {arch}: "
              f"the seed-0 parameters differ from the CLI engine's")
        del tree, lm_head
        torch.cuda.empty_cache()
        secs["a"] += time.perf_counter() - t0

    # b. decode vs forward (bf16 and f32) and c. slot-locality, per model
    cons, slots, peaks = {}, {}, {}
    for arch, layers in LMF["depth"].items():
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.replace(n_layers=layers)
        tree = open_gates(tfm.init_params(cfg, torch.Generator(
            device=DEVICE).manual_seed(0), DEVICE), LMF["gate"])
        n_params = sum(t.numel() for t in tree_leaves(tree))
        model = tfm.Transformer(cfg, tree)
        c = LM["consistency"]
        memory = lm_memory(cfg, c["batch"], c["prompt"], seed=2)
        cons[arch] = {"bf16": decode_consistency(arch, model, card,
                                                 prefix=prefix,
                                                 memory=memory)}
        t1 = time.perf_counter()
        slots[arch] = lm_slot_locality(prefix, arch, model, card,
                                       gated=not cfg.n_experts)
        c_s = time.perf_counter() - t1
        secs["c"] += c_s
        f32 = tfm.Transformer(cfg.replace(dtype=torch.float32), tree)
        cons[arch]["f32"] = decode_consistency(
            arch, f32, card, torch.float32, prefix=prefix, memory=memory)
        peaks[arch] = torch.cuda.max_memory_allocated()
        log(f"{prefix} {arch}: {cfg.n_layers} layers"
            f"{' + ' + str(cfg.n_enc_layers) + ' encoder' if cfg.is_encdec else ''}"
            f" at full width (d {cfg.d_model}, vocab {cfg.vocab}), "
            f"{n_params / 1e9:.3f} B parameters; max_memory_allocated "
            f"{peaks[arch] / 2 ** 30:.2f} GiB ({dtype_name(cfg.param_dtype)} "
            f"parameters, their {dtype_name(cfg.dtype)} copies, caches) "
            f"[{card}]")
        del model, f32, tree
        torch.cuda.empty_cache()
        for key, rec in cons[arch].items():
            check(rec["gate_err"] <= rec["bound"],
                  f"{prefix} b. {arch} {key}: {rec} over the bound")
        secs["b"] += time.perf_counter() - t0 - c_s

    # d. card against CPU, f32 with f32 caches, the CPU's copies in one
    # pinned block (the largest family's f32 tree, kimi-k2's included)
    t0 = time.perf_counter()
    park = HostPark(max(HostPark.need(leaf_shapes(cfg), 4) for cfg in [
        get_config(arch).replace(n_layers=layers, n_enc_layers=layers)
        for arch, layers in LMF["cpu_depth"].items()] + [
        kimi_config(KIMI["experts"]["f32"], f32=True)]))
    log(f"{prefix} d. {park.block.numel()} B of pinned host memory for the "
        f"CPU's copies, pinned in {time.perf_counter() - t0:.1f} s [{card}]")
    secs["d"] += time.perf_counter() - t0
    cpu = {}
    for arch, layers in LMF["cpu_depth"].items():
        t0 = time.perf_counter()
        cpu[arch] = lm_card_vs_cpu(card, arch, layers, prefix,
                                   made_on=DEVICE,
                                   cache_dtypes=(torch.float32,),
                                   gate=LMF["gate"], park=park)
        torch.cuda.empty_cache()
        secs["d"] += time.perf_counter() - t0

    kimi = kimi_serving(prefix, card, secs, park)
    del park

    # e. the recurrences' duality
    dual = {}
    for arch in LMF["dual"]:
        t0 = time.perf_counter()
        dual[arch] = lm_duality(prefix, arch, card)
        torch.cuda.empty_cache()
        secs["e"] += time.perf_counter() - t0
    launches = launcher.entry_launch_counts()
    check(not any(launches.values()), f"{prefix} launched {launches}")
    phase_s = time.perf_counter() - t_phase
    log(f"{prefix} {phase_s:.1f}s in all ("
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items())
        + f"); none of the 12 entry points launched [{card}]")
    return {"launches": launches, "cli": cli, "consistency": cons,
            "slots": slots, "cpu": cpu, "duality": dual, "peaks": peaks,
            "kimi": kimi, "phase_s": phase_s, "part_s": secs}


#: [main-train]: the LM training path.  a: the CLI at full size (the
#: checkpoint under build/); b: learning a repeated motif (the JAX test's
#: gate); c: card against CPU at full width; d: remat against none; e: the
#: smoke CLI's resume and compression on the card
TRAIN = dict(arch="qwen2-1.5b",
             cli=["--steps", "6", "--seq-len", "256", "--global-batch", "8",
                  "--warmup", "2", "--log-every", "2", "--ckpt-every",
                  "1000"],
             learn=dict(layers=2, steps=30, lr=3e-3, batch=4, seq=64,
                        motif=8, drop=0.5),
             cpu=dict(archs=("qwen2-1.5b", "mamba2-780m"), layers=2,
                      batch=2, seq=64, lr=3e-4),
             remat=dict(layers=4, block=4, batch=8, seq=256),
             smoke=dict(steps=6, cut=3),
             tol=1e-4, grad_floor=1e-3)


def train_cli(prefix: str, card) -> dict:
    """a: ``train --arch`` at full size through ``train.run``."""
    import re
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.optim.adamw import tree_leaves
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", TRAIN["arch"], *TRAIN["cli"], "--ckpt-dir", str(ckpt)]
    args = train.parse_args(argv)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = train.run(args)
    text = printed.getvalue()
    sys.stdout.write(text)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in re.findall(r" loss=(\S+) ", text)]
    check(len(losses) == args.steps // args.log_every
          and all(np.isfinite(losses)) and np.isfinite(out["final_loss"]),
          f"{prefix} a. logged losses {losses}, final {out['final_loss']}")
    step_ms = statistics.median(out["step_s"][1:]) * 1e3
    tokens = args.global_batch * args.seq_len
    state, bundle = out["state"], out["bundle"]
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    step_dir = ckpt / f"step_{args.steps:09d}"
    ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
    batch = SyntheticLM(get_config(args.arch), args.seq_len,
                        args.global_batch, seed=args.seed).batch(args.steps)
    n_kernels, busy_ms, wall_ms = kernel_trace(
        lambda: bundle.fn(state, batch), 1, host=False)
    # products only: the embedding table is a gather; the step's required
    # work is 6 N T, the remat recompute (layers and loss chunks) 2 N T more
    n_mm = n_params - state.params["embed"].numel()
    flops = 6 * n_mm * tokens
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3
    remat_ms = 2 * n_mm * tokens / BF16_FLOPS_PER_S * 1e3
    log(f"{prefix} a. train {' '.join(argv[:-2])}: losses {losses} (steps "
        f"{args.log_every}, {2 * args.log_every}, ...), final "
        f"{out['final_loss']:.4f}; median step {step_ms:.2f} ms (steps 2-"
        f"{args.steps}, first {out['step_s'][0] * 1e3:.1f} ms), "
        f"{tokens / step_ms * 1e3:.1f} tok/s; max_memory_allocated "
        f"{peak / 2 ** 30:.2f} GiB [{card}]")
    log(f"{prefix} a. one step ({n_params / 1e9:.4f} B parameters, "
        f"{tokens} tokens): {n_kernels:.0f} kernel launches, device busy "
        f"{busy_ms:.2f} ms of {wall_ms:.2f} ms wall (torch.profiler, "
        f"kernels only); FLOP "
        f"bound {bound_ms:.2f} ms (6 N T = {flops / 1e12:.2f} TFLOP, N = "
        f"{n_mm / 1e9:.4f} B without the embedding table, at "
        f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s dense bf16: reckoned, not "
        f"measured), {bound_ms + remat_ms:.2f} ms with the remat "
        f"recompute (8 N T) [{card}]")
    log(f"{prefix} a. final checkpoint (step {args.steps}): "
        f"{ckpt_bytes / 1e9:.2f} GB in {out['save_s']:.2f} s from the save "
        f"call to its commit ({ckpt_bytes / 1e9 / out['save_s']:.2f} GB/s, "
        f"the device-to-host copy included) [{card}]")
    shutil.rmtree(ckpt)
    return {"losses": losses, "final_loss": out["final_loss"],
            "step_ms": step_ms, "tok_s": tokens / step_ms * 1e3,
            "peak": peak, "launches_a_step": n_kernels, "busy_ms": busy_ms,
            "wall_ms": wall_ms, "bound_ms": bound_ms,
            "remat_bound_ms": bound_ms + remat_ms, "params": n_params,
            "ckpt_gb": ckpt_bytes / 1e9, "save_s": out["save_s"]}


def train_learns(prefix: str, card) -> dict:
    """b: 2 layers at full width learn a repeated motif."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    c = TRAIN["learn"]
    cfg = get_config(TRAIN["arch"]).replace(n_layers=c["layers"])
    params = tfm.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        3), DEVICE)
    model = tfm.Transformer(cfg, params, live=True)
    opt = adamw.init(params)
    motif = np.random.default_rng(3).integers(0, cfg.vocab, c["motif"])
    reps = -(-c["seq"] // c["motif"])
    batch = {"tokens": np.tile(motif, (c["batch"], reps))[:, :c["seq"]]}
    losses = []
    for _ in range(c["steps"]):
        (loss, _), grads = tfm.value_and_grad(model, cfg, batch)
        _, opt, _ = adamw.update(grads, opt, params, lr=c["lr"],
                                 weight_decay=0.0)
        losses.append(loss)
    losses = [float(v) for v in torch.stack(losses).cpu()]
    log(f"{prefix} b. {cfg.n_layers} layers at full width, {c['steps']} "
        f"steps at lr {c['lr']} on a repeated {c['motif']}-token motif "
        f"(B {c['batch']} x S {c['seq']}): loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (every 10th: "
        f"{[round(v, 4) for v in losses[::10]]}) [{card}]")
    check(losses[-1] < losses[0] - c["drop"], f"{prefix} b. loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}: not {c['drop']} lower")
    return {"first": losses[0], "last": losses[-1]}


def worst_ratio(got, want, tol: float, floor: float = 1.0) -> tuple:
    """(max over leaves of max|d| / (tol max(floor, max|want|)), leaves)."""
    worst = 0.0
    for g, w in zip(got, want):
        bound = tol * max(floor, float(w.float().abs().max()))
        worst = max(worst, float((g.float() - w.float()).abs().max()) / bound)
    return worst, len(want)


def train_card_vs_cpu(prefix: str, card) -> dict:
    """c: loss, gradients and one update, card against CPU, f32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    c = TRAIN["cpu"]
    out = {}
    for arch in c["archs"]:
        cfg = get_config(arch).replace(n_layers=c["layers"],
                                       dtype=torch.float32)
        tree = tfm.init_params(cfg, torch.Generator(
            device=DEVICE).manual_seed(0), DEVICE)
        on = {"card": tree, "cpu": tfm.tree_map(
            lambda t: t.to("cpu", copy=True), tree)}
        batch = SyntheticLM(cfg, c["seq"], c["batch"], seed=5).batch(0)
        got = {}
        for where, params in on.items():
            model = tfm.Transformer(cfg, params, live=True)
            (loss, _), grads = tfm.value_and_grad(model, cfg, batch)
            host = [g.cpu() for g in tree_leaves(grads)]
            opt = adamw.init(params)
            lr = adamw.warmup_cosine(opt.step, peak_lr=c["lr"], warmup=0,
                                     total=10)
            adamw.update(grads, opt, params, lr=lr)
            got[where] = (loss.cpu(), host,
                          [p.cpu() for p in tree_leaves(params)])
            del model, grads, opt
        del on, tree
        torch.cuda.empty_cache()
        r_loss, _ = worst_ratio([got["card"][0]], [got["cpu"][0]],
                                TRAIN["tol"])
        r_grad, n = worst_ratio(got["card"][1], got["cpu"][1], TRAIN["tol"],
                                TRAIN["grad_floor"])
        r_par, _ = worst_ratio(got["card"][2], got["cpu"][2], TRAIN["tol"])
        log(f"{prefix} c. {arch} (f32, {cfg.n_layers} layers at full width, "
            f"B {c['batch']} x S {c['seq']}, TF32 off) card vs CPU: loss "
            f"{float(got['card'][0]):.6f} vs {float(got['cpu'][0]):.6f}; "
            f"max|d| / bound: loss {r_loss:.3e}, {n} gradient leaves "
            f"{r_grad:.3e}, parameters after one AdamW update (lr "
            f"{c['lr']}) {r_par:.3e} (bound {TRAIN['tol']} x max(1, "
            f"max|.|) a leaf, for a gradient leaf {TRAIN['tol']} x max("
            f"{TRAIN['grad_floor']}, max|g|)) [{card}]")
        check(max(r_loss, r_grad, r_par) <= 1.0, f"{prefix} c. {arch}: "
              f"card vs CPU over the bound ({r_loss}, {r_grad}, {r_par})")
        out[arch] = {"loss": r_loss, "grads": r_grad, "params": r_par}
    return out


def train_remat(prefix: str, card) -> dict:
    """d: nested remat blocks against no remat at full width."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import tree_leaves
    c = TRAIN["remat"]
    cfg = get_config(TRAIN["arch"]).replace(n_layers=c["layers"],
                                            remat_block=c["block"])
    params = tfm.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        6), DEVICE)
    model = tfm.Transformer(cfg, params, live=True)
    batch = SyntheticLM(cfg, c["seq"], c["batch"], seed=6).batch(0)
    grads, peaks, ms = {}, {}, {}
    for remat in (True, False):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tfm.value_and_grad(model, cfg, batch, remat=remat)
        torch.cuda.synchronize()
        ms[remat] = (time.perf_counter() - t0) * 1e3
        peaks[remat] = torch.cuda.max_memory_allocated() - base
        grads[remat] = [g.clone() for g in tree_leaves(model.grads)]
    same = sum(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))
    ratio, n = worst_ratio(grads[True], grads[False], TRAIN["tol"],
                           TRAIN["grad_floor"])
    log(f"{prefix} d. {c['layers']} layers at full width, B {c['batch']} x "
        f"S {c['seq']}, {str(cfg.dtype).split('.')[-1]}: remat_block "
        f"{c['block']} against no remat: {same} of {n} gradient leaves "
        f"bitwise, max|d| / bound {ratio:.3e}; peak above the state "
        f"{peaks[True] / 2 ** 30:.3f} GiB with remat, "
        f"{peaks[False] / 2 ** 30:.3f} GiB without; {ms[True]:.1f} / "
        f"{ms[False]:.1f} ms (one call each, the first warm-up included) "
        f"[{card}]")
    check(ratio <= 1.0, f"{prefix} d. remat changed the gradients "
          f"({ratio:.3e} of the bound)")
    return {"bitwise": same, "leaves": n, "ratio": ratio,
            "peak_remat": peaks[True], "peak_plain": peaks[False]}


def train_smoke(prefix: str, card) -> dict:
    """e: the smoke CLI on the card, resumed and compressed."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.launch import train
    from repro_torch.optim.adamw import tree_leaves
    c = TRAIN["smoke"]
    root = ROOT / "build" / "train_smoke"
    shutil.rmtree(root, ignore_errors=True)

    def run(name, n, *extra):
        argv = ["--arch", TRAIN["arch"], "--smoke", "--steps", str(n),
                "--seq-len", "32", "--global-batch", "4", "--log-every",
                "3", "--ckpt-dir", str(root / name), *extra]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            out = train.run(train.parse_args(argv))
        return out, printed.getvalue()

    run("a", c["cut"])
    resumed, text = run("a", c["steps"], "--resume", "auto")
    whole, _ = run("b", c["steps"])
    check(f"resumed from step {c['cut']}" in text,
          f"{prefix} e. no resume line")
    same = [torch.equal(a, b) for a, b in zip(
        tree_leaves(resumed["state"]), tree_leaves(whole["state"]))]
    comp, _ = run("c", 4, "--grad-compress-ratio", "0.25")
    ef = tree_leaves(comp["state"].ef_err)
    shutil.rmtree(root)
    log(f"{prefix} e. --smoke: {c['cut']} steps, --resume auto to "
        f"{c['steps']}, against {c['steps']} at once: final loss "
        f"{resumed['final_loss']:.6f} vs {whole['final_loss']:.6f}, "
        f"{sum(same)} of {len(same)} state leaves bitwise; "
        f"--grad-compress-ratio 0.25: final loss {comp['final_loss']:.4f}, "
        f"{len(ef)} bf16 error-feedback buffers [{card}]")
    check(all(same) and resumed["final_loss"] == whole["final_loss"],
          f"{prefix} e. the resumed run differs from the uninterrupted one")
    check(np.isfinite(comp["final_loss"]) and ef
          and all(e.dtype == torch.bfloat16 for e in ef),
          f"{prefix} e. the compressed run: {comp['final_loss']}")
    return {"resumed": resumed["final_loss"], "whole": whole["final_loss"],
            "compressed": comp["final_loss"]}


def host_available() -> int:
    """The host's MemAvailable in bytes (``/proc/meminfo``)."""
    for line in pathlib.Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise SmokeFailure("no MemAvailable in /proc/meminfo")


#: entries of one piece of ``leafwise_update`` (256 MiB in f32)
UPDATE_PIECE = 2 ** 26


def leafwise_update(grads, params, lr, norm) -> None:
    """``adamw.update`` of one first step (zero f32 moments) on pieces of
    at most UPDATE_PIECE entries of each leaf, with the whole tree's
    global norm: the same elementwise arithmetic as the tree's update
    (its moments per entry, its norm given), written into the f32
    parameters in place, with the moments and transients of one piece
    alive at a time."""
    from repro_torch.optim import adamw
    for g, p in zip(adamw.tree_leaves(grads), adamw.tree_leaves(params)):
        for gp, pp in zip(g.view(-1).split(UPDATE_PIECE),
                          p.view(-1).split(UPDATE_PIECE)):
            adamw.update(gp, adamw.init(pp), pp, lr=lr, norm=norm)


def kimi_card_vs_cpu(prefix: str, card) -> dict:
    """f: kimi-k2 (i): loss, every gradient leaf and the parameters
    after one AdamW update, card against CPU, f32 (TF32 off), one layer
    at full width with KIMI's f32 expert cut, TRAIN's batch and
    tolerances.  The CPU side runs first and keeps its parameters and
    gradients (8 B a parameter); the card then computes its own and
    holds each leaf to the CPU's, moved over one at a time; both sides
    update piece by piece (``leafwise_update``).  Where the host's
    available memory cannot hold the CPU side, the gradients alone are
    compared, and the line says so."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    c = TRAIN["cpu"]
    e = KIMI["experts"]["f32"]
    cfg = kimi_config(e, f32=True)
    want = reckoned_params(cfg)
    # CPU: parameters and gradients, and one piece of the update (two
    # moments and at most six f32 transients)
    need = 2 * want["bytes"] + 8 * 4 * UPDATE_PIECE
    avail = host_available()
    update = avail >= need
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tree = tfm.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        0), DEVICE)
    host = tfm.tree_map(lambda t: t.to("cpu", copy=True), tree)
    batch = SyntheticLM(cfg, c["seq"], c["batch"], seed=5).batch(0)
    lr = adamw.warmup_cosine(torch.zeros((), dtype=torch.int32),
                             peak_lr=c["lr"], warmup=0, total=10)
    # no remat on either side: the same sums, one forward fewer
    t0 = time.perf_counter()
    model = tfm.Transformer(cfg, host, live=True)
    (loss_c, _), grads_c = tfm.value_and_grad(model, cfg, batch, remat=False)
    del model
    norm_c = adamw.global_norm(grads_c)
    if update:
        leafwise_update(grads_c, host, lr, norm_c)
    cpu_s = time.perf_counter() - t0
    model = tfm.Transformer(cfg, tree, live=True)
    (loss, _), grads = tfm.value_and_grad(model, cfg, batch, remat=False)
    del model
    r_loss, _ = worst_ratio([loss.cpu()], [loss_c], TRAIN["tol"])
    if update:
        leafwise_update(grads, tree, lr, adamw.global_norm(grads))
    # each leaf of the CPU's moved over once: its gradient, and after the
    # update its parameter, held entry by entry within how far the
    # gradients' and norm's tolerance can move AdamW's first step (lr x
    # the spread of g / (|g| + eps), up to 2 lr where |g| is near eps: a
    # sparse MoE gradient has many such entries), as [main-sharded] a
    # holds it; the reading on the parameters' scale printed beside it
    r_grad = n = 0
    r_par = r_scale = 0.0 if update else None
    for g, p, g_c, p_c in zip(tree_leaves(grads), tree_leaves(tree),
                              tree_leaves(grads_c), tree_leaves(host)):
        g_c = g_c.to(DEVICE)
        r_grad = max(r_grad, worst_ratio([g], [g_c], TRAIN["tol"],
                                         TRAIN["grad_floor"])[0])
        n += 1
        if update:
            p_c = p_c.to(DEVICE)
            bound = adamw.first_step_tolerance(
                [g_c], [p_c], norm_c, lr=lr, grad_tol=TRAIN["tol"],
                grad_floor=TRAIN["grad_floor"], norm_tol=TRAIN["tol"])
            r_par = max(r_par, moved_ratio([p], [p_c], bound))
            r_scale = max(r_scale, worst_ratio([p], [p_c], TRAIN["tol"])[0])
            del p_c, bound
        del g_c
    del grads_c
    peak = torch.cuda.max_memory_allocated() - base
    del tree, grads, host
    torch.cuda.empty_cache()
    log(f"{prefix} f. {KIMI['arch']} (i) (f32, {cfg.n_layers} layer at "
        f"full width, {e} of 384 experts, top {cfg.top_k}, B {c['batch']} "
        f"x S {c['seq']}, TF32 off) card vs CPU: loss {float(loss):.6f} vs "
        f"{float(loss_c):.6f}; max|d| / bound: loss {r_loss:.3e}, {n} "
        f"gradient leaves {r_grad:.3e}"
        + (f", parameters after one AdamW update (lr {c['lr']}) "
           f"{r_par:.3e} (adamw.first_step_tolerance of the gradient and "
           f"norm bounds; on the parameters' scale, {TRAIN['tol']} x "
           f"max(1, max|p|), {r_scale:.3e}, printed, not gated)"
           if update else
           ", no update: the host's available memory cannot hold the CPU "
           "side's update")
        + f" (bound {TRAIN['tol']} x max(1, |loss|) for the loss, "
        f"{TRAIN['tol']} x max({TRAIN['grad_floor']}, max|g|) a gradient "
        f"leaf); {want['params']} parameters; host MemAvailable "
        f"{avail / 1e9:.3f} GB before, the CPU side needs "
        f"{need / 1e9:.3f} GB reckoned; the CPU's step {cpu_s:.1f} s; "
        f"max_memory_allocated {peak / 1e9:.3f} GB above the "
        f"{base / 1e9:.3f} GB held before [{card}]")
    check(max(r_loss, r_grad, r_par or 0.0) <= 1.0, f"{prefix} f. "
          f"card vs CPU over the bound ({r_loss}, {r_grad}, {r_par})")
    return {"loss": r_loss, "grads": r_grad, "params": r_par,
            "params_scale": r_scale, "host_available": avail,
            "host_need": need, "peak": peak}


def kimi_recipe_step(prefix: str, card) -> dict:
    """g: kimi-k2 (ii): the recipe's step on the card, bf16 parameters
    and moments, one layer at full width with KIMI's train expert cut,
    ``KIMI["step"]`` steps of ``make_train_step``: every gradient and
    moment leaf finite, the moments bf16, the first step's loss within
    the bf16 LM bound of an f32 ``forward``'s loss on the same
    parameters and batch; step ms, tok/s, the second step's launches
    and busy ms beside 6 N T at 989 TFLOP/s, the peak beside the
    arithmetic."""
    import numpy as np
    import torch
    from repro_torch.configs import get_recipe
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import steps
    k = KIMI["step"]
    e = KIMI["experts"]["train"]
    cfg = kimi_config(e)
    recipe = get_recipe(KIMI["arch"])
    moment = recipe["moment_dtype"]
    want = reckoned_params(cfg)
    n = want["params"]
    # parameters, gradients and two moments at 2 B, and the update's six
    # f32 copies of the largest leaf (g, m, v, the step, the decay term)
    reckoned = 8 * n + 6 * 4 * want["largest"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = tfm.init_params(cfg, torch.Generator(
        device=DEVICE).manual_seed(0), DEVICE)
    batches = [SyntheticLM(cfg, k["seq"], k["batch"], seed=0).batch(i)
               for i in range(k["steps"])]
    with torch.no_grad():   # f32 compute copies of the same parameters
        f32 = tfm.Transformer(cfg.replace(dtype=torch.float32), params)
        loss32 = float(tfm.loss_fn(f32, f32.cfg, batches[0])[0])
        del f32
    torch.cuda.empty_cache()
    state = steps.TrainState(params, adamw.init(params, moment), None)
    bundle = steps.make_train_step(cfg, seq_len=k["seq"],
                                   global_batch=k["batch"],
                                   moment_dtype=moment, device=DEVICE,
                                   peak_lr=3e-4, warmup=0, total_steps=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = bundle.fn(state, batches[0])
    loss = float(m["loss"])
    first_ms = (time.perf_counter() - t0) * 1e3
    grads = tree_leaves(bundle.fn.live["model"].grads)
    finite = [bool(torch.isfinite(t).all()) for t in
              grads + tree_leaves(state.opt.mu) + tree_leaves(state.opt.nu)]
    dtypes = {str(t.dtype) for t in tree_leaves(state.opt.mu)
              + tree_leaves(state.opt.nu)}
    del grads
    n_kernels, busy_ms, step_ms = kernel_trace(
        lambda: bundle.fn(state, batches[1]), 1, host=False)
    peak = torch.cuda.max_memory_allocated() - base
    tokens = k["batch"] * k["seq"]
    active = n - cfg.vocab * cfg.d_model - (e - cfg.top_k) * 3 * (
        cfg.d_model * cfg.d_ff)
    bound_ms = 6 * active * tokens / BF16_FLOPS_PER_S * 1e3
    lm_tol = LM["tol"]["bfloat16"] * max(1.0, abs(loss32))
    log(f"{prefix} g. {KIMI['arch']} (ii) the recipe's step "
        f"(bf16 parameters and {dtype_name(moment)} moments, bf16 compute, "
        f"{cfg.n_layers} layer at full width, {e} of 384 experts, B "
        f"{k['batch']} x S {k['seq']}, {k['steps']} steps of "
        f"make_train_step): first loss {loss:.6f} against an f32 forward's "
        f"{loss32:.6f} on the same parameters and batch, |d| "
        f"{abs(loss - loss32):.3e} (bound {lm_tol:.3e}); {sum(finite)} of "
        f"{len(finite)} gradient and moment leaves finite, moments "
        f"{sorted(dtypes)}; first step {first_ms:.1f} ms, second "
        f"{step_ms:.1f} ms traced ({tokens / step_ms * 1e3:.1f} tok/s), "
        f"{n_kernels:.0f} kernel launches, device busy {busy_ms:.2f} ms "
        f"(torch.profiler, kernels only); FLOP bound {bound_ms:.2f} ms (6 N "
        f"T, N = {active / 1e9:.4f} B active a token without the embedding "
        f"table, at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s dense bf16: "
        f"reckoned, not measured); {n} parameters, max_memory_allocated "
        f"{peak / 1e9:.3f} GB above the {base / 1e9:.3f} GB held before "
        f"against {reckoned / 1e9:.3f} GB reckoned (8 B a parameter and "
        f"AdamW's six f32 copies of the {want['largest']}-entry leaf) "
        f"[{card}]")
    check(all(finite) and dtypes == {str(moment)}
          and abs(loss - loss32) <= lm_tol and np.isfinite(loss),
          f"{prefix} g. kimi-k2 recipe step: finite {sum(finite)} of "
          f"{len(finite)}, moments {dtypes}, loss {loss} vs {loss32}")
    del state, bundle
    torch.cuda.empty_cache()
    return {"loss": loss, "loss_f32": loss32, "first_ms": first_ms,
            "step_ms": step_ms, "tok_s": tokens / step_ms * 1e3,
            "launches_a_step": n_kernels, "busy_ms": busy_ms,
            "bound_ms": bound_ms, "peak": peak, "reckoned": reckoned,
            "params": n}


def phase_main_train(card) -> dict:
    """[main-train]: the LM training path (TRAIN)."""
    import torch
    from repro_torch.kernels import launcher
    prefix = "[main-train]"
    t_phase = time.perf_counter()
    secs = {}
    launcher.reset_launch_counts()
    out = {}
    for part, fn in (("a", train_cli), ("b", train_learns),
                     ("c", train_card_vs_cpu), ("d", train_remat),
                     ("e", train_smoke), ("f", kimi_card_vs_cpu),
                     ("g", kimi_recipe_step)):
        t0 = time.perf_counter()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out[part] = fn(prefix, card)
        torch.cuda.empty_cache()
        secs[part] = time.perf_counter() - t0
    launches = launcher.entry_launch_counts()
    check(not any(launches.values()), f"{prefix} launched {launches}")
    phase_s = time.perf_counter() - t_phase
    log(f"{prefix} {phase_s:.1f}s in all ("
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items())
        + f"); none of the 12 entry points launched [{card}]")
    return {"launches": launches, **out, "phase_s": phase_s,
            "part_s": secs}


#: [main-placed]: logical devices the one card is split into, the padded
#: batch of part c (64 -> 96 rows), and part e's small dynamic fleet
PLACED = dict(devices=4, pad_to=96, small=dict(graphs=8, n=64, g=192),
              reps=20)


def placed_engines(tag, basis, laps, family, counts) -> dict:
    """[main-placed] a/b: ``basis`` served unplaced and through
    ``single_bucket_placement`` on ``make_local_mesh()`` (one device on a
    one-card machine) and on PLACED["devices"] logical devices of the
    card.  Every tier's ``step`` (lowpass) and ``step_versioned``, and the
    F = 7 bank, bitwise the unplaced engine's; each dispatch launched once
    per shard (counts zeroed just before, read just after); ms per
    dispatch, placed beside unplaced."""
    import torch
    from repro_torch.kernels import launcher
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import logical_devices, make_local_mesh
    from repro_torch.runtime.sharding import single_bucket_placement
    tiers = serve.parse_tiers(MAIN["tiers"])
    common = dict(basis=basis, tiers=tiers, filters=MAIN["filters"],
                  kind=family, device=DEVICE)
    flat = serve.FGFTServeEngine(laps, **common)
    b, n = int(basis.spectrum.shape[0]), basis.n
    gen = torch.Generator(device=DEVICE).manual_seed(71)
    x = torch.randn((b, MAIN["signals"], n), generator=gen, device=DEVICE)
    op = ("batched_sym_operator_apply" if family == "sym"
          else "batched_gen_operator_apply")
    bank = ("batched_sym_filter_bank_apply" if family == "sym"
            else "batched_gen_filter_bank_apply")
    with logical_devices(PLACED["devices"], DEVICE):
        logical = make_local_mesh(device=DEVICE)
    out = {}
    for name, mesh in (("1 device", make_local_mesh(device=DEVICE)),
                       (f"{PLACED['devices']} logical", logical)):
        pl = single_bucket_placement(mesh, b)
        placed = serve.FGFTServeEngine(laps, placement=pl, **common)
        shards = pl.num_devices
        for tier in tiers:
            want = flat.step(x, lowpass, tier=tier)
            launcher.reset_launch_counts()
            got = placed.step(x, lowpass, tier=tier)
            sync()
            seen = launcher.entry_launch_counts()
            counts.update(seen)
            check(seen[op] == shards, f"[{tag}] {name}, tier {tier}: "
                  f"{seen[op]} operator launches for {shards} shards")
            check(torch.equal(got, want), f"[{tag}] {name}, tier {tier}: "
                  "placed step differs from unplaced")
            got_v, ver = placed.step_versioned(x, tier=tier)
            check(torch.equal(got_v, flat.step_versioned(x, tier=tier)[0])
                  and ver == 0, f"[{tag}] {name}, tier {tier}: "
                  "step_versioned differs")
        want = flat.step_bank(x)
        launcher.reset_launch_counts()
        got = placed.step_bank(x)
        sync()
        seen = launcher.entry_launch_counts()
        counts.update(seen)
        check(seen[bank] == shards, f"[{tag}] {name}: {seen[bank]} bank "
              f"launches for {shards} shards")
        check(torch.equal(got, want), f"[{tag}] {name}: placed bank "
              "differs from unplaced")
        with uncounted():
            ms = {"placed": time_ms(lambda: placed.step(x, lowpass),
                                    reps=PLACED["reps"]),
                  "unplaced": time_ms(lambda: flat.step(x, lowpass),
                                      reps=PLACED["reps"]),
                  "placed_bank": time_ms(lambda: placed.step_bank(x),
                                         reps=PLACED["reps"]),
                  "unplaced_bank": time_ms(lambda: flat.step_bank(x),
                                           reps=PLACED["reps"])}
        out[name] = {"shards": shards, **ms}
        log(f"[{tag}] {name} ({shards} shard{'s' * (shards > 1)} of "
            f"{pl.rows} graphs): {len(tiers)} tiers, step_versioned and "
            f"the F = {len(flat.bank)} bank bitwise the unplaced engine's, "
            f"{shards} launch{'es' * (shards > 1)} per dispatch; full tier "
            f"{ms['placed']:.4f} ms per placed dispatch vs "
            f"{ms['unplaced']:.4f} unplaced, bank {ms['placed_bank']:.4f} "
            f"vs {ms['unplaced_bank']:.4f} (R = {MAIN['signals']})")
    return out


def placed_pad_rows(tag, basis, family, counts) -> dict:
    """[main-placed] c: ``pad_batch`` of ``basis``'s tables to
    PLACED["pad_to"] rows through chain, operator and bank, f32 and bf16
    tables: the real rows bitwise the unpadded launch, pad rows bitwise
    their input through the chain and exactly 0 through the operator and
    the bank (zero spectrum and gain rows)."""
    import torch
    from repro_torch.core.staging import pad_batch, with_precision
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import ApplyPlan
    from repro_torch.spectral import SpectralFilterBank, named_responses
    b, n, r = int(basis.spectrum.shape[0]), basis.n, MAIN["signals"]
    bp = PLACED["pad_to"]
    gen = torch.Generator(device=DEVICE).manual_seed(72)
    x = torch.randn((bp, r, n), generator=gen, device=DEVICE)
    spec = torch.cat([basis.spectrum, basis.spectrum.new_zeros(bp - b, n)])
    real = SpectralFilterBank(basis, named_responses(MAIN["filters"])).gains()
    gains = torch.cat([real, real.new_zeros((bp - b,) + real.shape[1:])])
    out = {}
    for precision in ("f32", "bf16"):
        kw = dict(family=family, n=n, batched=True, precision=precision,
                  device=DEVICE)
        fwd = with_precision(basis.fwd, precision)
        bwd = with_precision(basis.bwd, precision)
        pf, pb = pad_batch(fwd, bp), pad_batch(bwd, bp)
        a_keep = "head" if family == "sym" else "tail"
        chain = ApplyPlan(mode="apply", keep=a_keep, **kw)
        op, bk = ApplyPlan(mode="operator", **kw), ApplyPlan(mode="bank",
                                                              **kw)
        with uncounted():
            want = (chain.apply(bwd, x[:b].contiguous()),
                    op.operator(fwd, bwd, basis.spectrum, x[:b].contiguous()),
                    bk.bank(fwd, bwd, gains[:b].contiguous(),
                            x[:b].contiguous()))
        launcher.reset_launch_counts()
        got = (chain.apply(pb, x), op.operator(pf, pb, spec, x),
               bk.bank(pf, pb, gains, x))
        sync()
        seen = launcher.entry_launch_counts()
        counts.update(seen)
        forms = {k for k, v in seen.items() if v}
        check(len(forms) == 3 and all(
            k.endswith("_bf16") == (precision == "bf16") for k in forms),
            f"[{tag}] pad rows {precision}: launched {seen}")
        for what, g, w in zip(("chain", "operator", "bank"), got, want):
            check(torch.equal(g[:b], w), f"[{tag}] pad rows {precision}: "
                  f"{what}'s real rows differ from the unpadded launch")
        check(torch.equal(got[0][b:], x[b:]), f"[{tag}] pad rows "
              f"{precision}: the chain does not pass pad rows through")
        check(not bool(got[1][b:].any()) and not bool(got[2][b:].any()),
              f"[{tag}] pad rows {precision}: operator or bank pad rows "
              "are not 0")
        out[precision] = {k: v for k, v in seen.items() if v}
    log(f"[{tag}] pad rows ({family}, {b} -> {bp} rows, R = {r}): chain, "
        f"operator and bank at f32 and bf16 tables: real rows bitwise the "
        f"unpadded launches, pad rows bitwise their input through the "
        f"chain and exactly 0 through the operator and the bank; launches "
        f"{out}")
    return out


def placed_ragged(tag, ragged, counts) -> dict:
    """[main-placed] d: [main-ragged]'s saved router loaded with
    ``placement="auto"`` on ``make_local_mesh()`` and on PLACED["devices"]
    logical devices: every tier and bucket bitwise the saved (unplaced)
    router's; the placed router saved (``placement.json`` written) and
    loaded back, its tables and steps bitwise."""
    import json as _json
    import shutil
    import torch
    from repro_torch.core.staging import table_arrays
    from repro_torch.kernels import launcher
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import logical_devices, make_local_mesh
    ckpt = ROOT / "build" / "ragged_checkpoint"
    flat = ragged["out"]["router"]
    x = ragged["out"]["signals"]
    tiers = list(flat.engines[max(flat.engines)].tiers)
    with logical_devices(PLACED["devices"], DEVICE):
        logical = make_local_mesh(device=DEVICE)
    out = {}
    for name, mesh in (("1 device", make_local_mesh(device=DEVICE)),
                       (f"{PLACED['devices']} logical", logical)):
        t0 = time.perf_counter()
        placed = serve.RaggedFGFTServeEngine.load(
            ckpt, placement="auto", mesh=mesh, device=DEVICE)
        sync()
        load_s = time.perf_counter() - t0
        launcher.reset_launch_counts()
        for tier in tiers:
            with uncounted():
                want = flat.step(x, lowpass, tier=tier)
                sync()
            for pos, (a, b) in enumerate(zip(
                    placed.step(x, lowpass, tier=tier), want)):
                check(torch.equal(a, b), f"[{tag}] ragged {name}, tier "
                      f"{tier}: graph {pos} differs from unplaced")
        sync()
        seen = launcher.entry_launch_counts()
        counts.update(seen)
        shards = sum(p.num_devices for _, p in placed.placement.items())
        op = seen["batched_sym_operator_apply"]
        check(op == len(tiers) * shards, f"[{tag}] ragged {name}: {op} "
              f"operator launches for {len(tiers)} tiers of {shards} "
              "shards")
        out[name] = {"manifest": placed.placement.manifest(),
                     "load_s": load_s}
        log(f"[{tag}] ragged router re-placed on {name}: "
            f"{placed.placement.manifest()['buckets']}; every tier of "
            f"every bucket bitwise the unplaced router's; loaded in "
            f"{load_s:.2f}s")
    saved = ROOT / "build" / "placed_router"
    shutil.rmtree(saved, ignore_errors=True)
    placed.save(saved)
    manifest = _json.loads((saved / "placement.json").read_text())
    check(manifest == placed.placement.manifest(),
          f"[{tag}] placement.json {manifest}")
    with logical_devices(PLACED["devices"], DEVICE):
        back = serve.RaggedFGFTServeEngine.load(saved, device=DEVICE)
    check(back.placement is not None and back.placement.manifest()
          == manifest, f"[{tag}] the placed router did not load placed")
    for w, eng in placed.engines.items():
        for leg in ("fwd", "bwd"):
            for a, b in zip(table_arrays(getattr(eng.basis, leg)),
                            table_arrays(getattr(back.engines[w].basis,
                                                 leg))):
                check(torch.equal(a, b), f"[{tag}] bucket {w}: restored "
                      f"{leg} tables differ")
    with uncounted():
        for a, b in zip(back.step(x, lowpass), placed.step(x, lowpass)):
            check(torch.equal(a, b), f"[{tag}] restored placed router "
                  "serves differently")
    shutil.rmtree(saved)
    log(f"[{tag}] placed router saved (placement.json {manifest}) and "
        f"loaded back placed: tables and steps bitwise")
    return out


def placed_dynamic(tag, counts) -> dict:
    """[main-placed] e/f: a small fleet (PLACED["small"]) fitted unplaced
    and with ``fit(mesh=)`` on PLACED["devices"] logical devices (factors
    bitwise), then a dynamic engine on each, the second placed on the
    logical devices: one forced REFRESH and one forced EXTEND (the placed
    EXTEND splits over the devices), tick for tick the same actions,
    drift and versions and every served tier bitwise; no new plan and no
    new entry stream across the REFRESH swap."""
    import numpy as np
    import torch
    from repro_torch.core import ApproxEigenbasis, laplacian
    from repro_torch.graphs import community_graph
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import plan_cache_stats
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import logical_devices, make_local_mesh
    from repro_torch.runtime.sharding import single_bucket_placement
    small = PLACED["small"]
    b, n, g = small["graphs"], small["n"], small["g"]
    laps = np.stack([laplacian(community_graph(n, seed=300 + s))
                     for s in range(b)])
    with logical_devices(PLACED["devices"], DEVICE):
        mesh = make_local_mesh(device=DEVICE)
    t0 = time.perf_counter()
    flat_basis = ApproxEigenbasis.fit(laps, g, n_iter=1, device=DEVICE)
    sync()
    t1 = time.perf_counter()
    mesh_basis = ApproxEigenbasis.fit(laps, g, n_iter=1, mesh=mesh,
                                      device=DEVICE)
    sync()
    t2 = time.perf_counter()
    for a, c in zip(flat_basis.factors + (flat_basis.spectrum,
                                          flat_basis.objective),
                    mesh_basis.factors + (mesh_basis.spectrum,
                                          mesh_basis.objective)):
        check(torch.equal(a, c), f"[{tag}] fit(mesh=) differs from the "
              "unplaced fit")
    log(f"[{tag}] fit(mesh=) of {b} graphs, n = {n}, g = {g} on "
        f"{PLACED['devices']} logical devices: factors, spectrum and "
        f"objective bitwise the unplaced fit's ({t2 - t1:.2f}s vs "
        f"{t1 - t0:.2f}s unplaced)")
    tiers = serve.parse_tiers(MAIN["tiers"])
    flat = serve.FGFTServeEngine(laps, basis=flat_basis, tiers=tiers,
                                 dynamic=True, device=DEVICE)
    placed = serve.FGFTServeEngine(
        laps, basis=mesh_basis, tiers=tiers, dynamic=True, device=DEVICE,
        placement=single_bucket_placement(mesh, b))
    gen = torch.Generator(device=DEVICE).manual_seed(73)
    x = torch.randn((b, 32, n), generator=gen, device=DEVICE)
    rng = np.random.default_rng(74)
    ticks = []
    for rnd, (action, mult) in enumerate((("refresh", (0.1, 1e6, 2e6)),
                                          ("extend", (0.01, 0.1, 1e6)))):
        delta = rng.standard_normal((n, n)).astype(np.float32) * 0.05
        delta = delta + delta.T
        res, streams = {}, {}
        for key, eng in (("flat", flat), ("placed", placed)):
            eng.apply_updates(rnd, delta)
            pol = eng.controller.policy
            eng.controller.policy = replace_policy(pol, 1e9, 1e9, 1e9)
            check(eng.maintain()["action"] == "reuse", f"[{tag}] quiet tick")
            d = float(eng.drift().max())
            eng.controller.policy = replace_policy(
                pol, *(m * d for m in mult))
            misses = plan_cache_stats()["misses"]
            launcher.reset_stream_cache_counts()
            launcher.reset_launch_counts()
            res[key] = eng.maintain()
            sync()
            if eng is placed:
                counts.update(launcher.entry_launch_counts())
            streams[key] = (plan_cache_stats()["misses"] - misses,
                            launcher.stream_cache_counts())
        check(res["flat"]["action"] == res["placed"]["action"] == action,
              f"[{tag}] ticks took {res['flat']['action']} and "
              f"{res['placed']['action']}, want {action}")
        for k in ("drift", "post_drift", "versions"):
            check(np.array_equal(res["flat"][k], res["placed"][k]),
                  f"[{tag}] {action}: {k} differs")
        if action == "refresh":
            check(streams["placed"][0] == 0
                  and streams["placed"][1]["misses"] == 0,
                  f"[{tag}] the placed REFRESH built plans or streams: "
                  f"{streams['placed']}")
        launcher.reset_launch_counts()
        for tier in tiers:
            with uncounted():
                want = flat.step(x, lowpass, tier=tier)
            got = placed.step(x, lowpass, tier=tier)
            check(torch.equal(got, want), f"[{tag}] after {action}, tier "
                  f"{tier}: placed step differs")
        sync()
        counts.update(launcher.entry_launch_counts())
        ticks.append({"action": action, "plan_misses_and_streams": streams})
        log(f"[{tag}] placed dynamic engine, forced {action.upper()}: "
            f"drift, post-action drift and versions "
            f"{res['placed']['versions'].tolist()} equal to the unplaced "
            f"engine's, every tier bitwise after the swap; new plans / "
            f"entry-stream cache (placed) {streams['placed']}, (unplaced) "
            f"{streams['flat']}")
    return {"ticks": ticks, "fit_s": t1 - t0, "mesh_fit_s": t2 - t1}


def replace_policy(policy, refresh, extend, refit):
    from dataclasses import replace
    return replace(policy, refresh=refresh, extend=extend, refit=refit)


def phase_main_placed(errs, main, main_dir, ragged) -> dict:
    """[main-placed]: fleet placement (runtime/sharding.py) on the tables
    the earlier phases fitted; every part driven with the counts zeroed
    just before and read just after (comparisons not counted).  a. the
    [main] basis (B = 64, n = 256, g = 4096) served through
    ``single_bucket_placement`` on ``make_local_mesh()`` and on 4 logical
    devices of the card, bitwise the unplaced engine; b. the same on the
    [main-directed] basis; c. pad rows through all six kernels, f32 and
    bf16 tables; d. [main-ragged]'s saved router re-placed and saved
    placed; e/f. a small placed dynamic engine and ``fit(mesh=)``."""
    from collections import Counter
    t_phase = time.perf_counter()
    counts: Counter = Counter()
    tag = "main-placed"
    secs = {}
    t0 = time.perf_counter()
    m_out, d_out = main["out"], main_dir["out"]
    out = {"a": placed_engines(tag, m_out["engine"].basis, m_out["laps"],
                               "sym", counts)}
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["b"] = placed_engines(f"{tag} directed", d_out["engine"].basis,
                              d_out["laps"], "general", counts)
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["c"] = {"sym": placed_pad_rows(tag, m_out["engine"].basis, "sym",
                                       counts),
                "general": placed_pad_rows(tag, d_out["engine"].basis,
                                           "general", counts)}
    secs["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["d"] = placed_ragged(tag, ragged, counts)
    secs["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["e"] = placed_dynamic(tag, counts)
    secs["e"] = time.perf_counter() - t0
    for entry in ("batched_sym_operator_apply", "batched_gen_operator_apply",
                  "batched_sym_filter_bank_apply",
                  "batched_gen_filter_bank_apply", "batched_butterfly_apply",
                  "batched_shear_apply"):
        check(counts[entry] > 0, f"[{tag}] never launched {entry}")
    phase_s = time.perf_counter() - t_phase
    log(f"[{tag}] {phase_s:.1f}s in all ("
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items())
        + f"); launches {dict(counts)}")
    return {"launches": dict(counts), **out, "phase_s": phase_s,
            "part_s": secs}


#: the async front end of [main-async]: R-row requests from closed-loop
#: tenants through AsyncFGFTService on the tables the earlier phases
#: fitted (no fit at full width); the dynamic part's churn and refresh
#: threshold; the CLI at a small size for the wiring
#: [main-async]: request counts of parts a-d (a's tier load and its
#: bank load, b, c and d; a-c cut to half for the run's time limit, d
#: not: its ticks must swap while it runs)
ASYNC = dict(requests=2048, bank_requests=512, directed_requests=512,
             ragged_requests=512, dynamic_requests=2048, rows=8,
             workers=16, max_queue=128, max_batch=8, churn=0.002,
             maintain_interval=0.05, refresh=0.002,
             cli=["--fgft", "--serve-async", "--dynamic", "--graphs", "8",
                  "--graph-n", "64", "--load-requests", "256",
                  "--load-workers", "4"])

#: [main-dryrun]: the dry run on the production meshes (a), its one-device
#: prediction against [main-train]'s configuration on the card (b), and
#: the argument bytes of that state placed on 4 logical devices (c);
#: ``seq``, ``batch``: [main-train]'s CLI step (TRAIN); ``cells``: a's
#: cells, the single mesh's and the multi mesh's ``pod_compress`` one
#: (the multi mesh's plain cell, the same traces and one more
#: representative trace, ~17 s, is left out for the run's time limit)
DRYRUN = dict(arch=TRAIN["arch"], shape="train_4k", seq=256, batch=8,
              cells=(("single", None), ("multi", {"pod_compress": True})),
              logical=4, model_axis=2, flop_tol=0.01,
              products=("aten::mm", "aten::addmm", "aten::bmm",
                        "aten::baddbmm"))


def dryrun_cells(prefix: str, card) -> dict:
    """a: ``run_cell`` of qwen2-1.5b train_4k on both production meshes
    (DRYRUN's cells), on ``meta`` (one global and one data-shard trace
    serve both; each cell's collectives from its step traced for one
    id): the single mesh's cell, then the multi mesh's ``pod_compress``
    cell: its cross-pod bytes under half of all its collective bytes
    (the JAX test's gate)."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.runtime import hlo_analysis as hlo
    total = torch.cuda.get_device_properties(0).total_memory
    out = {}
    for kind, over in DRYRUN["cells"]:
        t0 = time.perf_counter()
        res = dryrun.run_cell(DRYRUN["arch"], DRYRUN["shape"], kind, over)
        mem, r = res["memory"], res["roofline"]
        terms = {k: r[f"{k}_s"] for k in ("compute", "memory",
                                           "collective")}
        tag = kind + (" pod_compress" if over else "")
        check(res["n_chips"] == (256 if kind == "single" else 512)
              and mem["argument_size_in_bytes"] > 0
              and r["unavailable"] == []
              and all(r[k] is not None for k in hlo.UNAVAILABLE)
              and r["collective_bytes"] > 0
              and r["dominant"] == max(terms, key=terms.get),
              f"{prefix} a. {tag}: {res['n_chips']} chips, {mem}, {r}")
        if over:
            check(0 < r["cross_pod_bytes"] < 0.5 * r["collective_bytes"],
                  f"{prefix} a. {tag}: cross-pod bytes "
                  f"{r['cross_pod_bytes']} of {r['collective_bytes']}")
        kinds = {k: v for k, v in r["collective_by_kind"].items() if v}
        log(f"{prefix} a. {DRYRUN['arch']} {DRYRUN['shape']} {tag} "
            f"({res['n_chips']} chips, meta): per device "
            f"{mem['per_device_bytes'] / 1e9:.3f} GB (arguments "
            f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB exact, temp "
            f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB at batch "
            f"{res['temp_batch']}, {res['temp_basis']}: an upper bound) "
            f"against this card's total_memory {total / 1e9:.3f} GB; "
            f"compute {r['compute_s']:.4e} s, memory {r['memory_s']:.4e} "
            f"s, collective {r['collective_s']:.4e} s "
            f"(collective_bytes {r['collective_bytes']}, cross_pod_bytes "
            f"{r['cross_pod_bytes']}"
            + (f", {r['cross_pod_bytes'] / r['collective_bytes']:.4f} of "
               "them, gate < 0.5" if over else "")
            + f"; by kind {kinds}, ops {r['collective_counts']}), "
            f"dominant {r['dominant']}, useful_flop_frac "
            f"{res['useful_flop_frac']:.4f} (H100 constants: reckoned, "
            f"not measured); traces {res['lower_s']} s + "
            f"{res['compile_s']} s (shared by the cells) + "
            f"{res['collective_trace_s']} s (the representative trace), "
            f"cell {time.perf_counter() - t0:.1f} s [{card}]")
        out[tag] = {"per_device_gb": mem["per_device_bytes"] / 1e9,
                    "dominant": r["dominant"],
                    "collective_bytes": r["collective_bytes"],
                    "cross_pod_bytes": r["cross_pod_bytes"],
                    "by_kind": kinds,
                    "cell_s": time.perf_counter() - t0}
    return out


def _train_setup():
    """[main-train]'s step at full size: (config, recipe, shape, a fresh
    state on the card, the step, a batch on the card)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_recipe
    from repro_torch.configs.shapes import Shape
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime import steps
    cfg = get_config(DRYRUN["arch"])
    recipe = get_recipe(DRYRUN["arch"])
    shape = Shape("main-train", DRYRUN["seq"], DRYRUN["batch"], "train")
    state = steps.concrete_train_state(
        cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE,
        moment_dtype=recipe["moment_dtype"])
    bundle = steps.make_train_step(
        cfg, seq_len=shape.seq_len, global_batch=shape.global_batch,
        moment_dtype=recipe["moment_dtype"], device=DEVICE)
    host = SyntheticLM(cfg, shape.seq_len, shape.global_batch,
                       seed=0).batch(0)
    batch = {k: torch.as_tensor(np.asarray(v)).to(DEVICE)
             for k, v in host.items()}
    return cfg, recipe, shape, state, bundle, batch


def dryrun_one_device(prefix: str, card, setup) -> dict:
    """b: the dry run's prediction on a 1x1 mesh against one real step:
    argument bytes exactly the state's and batch's tensors, dot FLOPs
    within 1% of the profiler's product events that launched a kernel,
    the predicted peak beside ``max_memory_allocated``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh, process_devices
    from repro_torch.optim.adamw import tree_leaves
    cfg, recipe, shape, state, bundle, batch = setup
    mesh = Mesh([[0]], ("data", "model"), process_devices("meta", 1))
    t0 = time.perf_counter()
    pred = dryrun.analyze(cfg, recipe, shape, mesh)
    pred_s = time.perf_counter() - t0
    held = sum(t.numel() * t.element_size()
               for t in tree_leaves(state) + list(batch.values()))
    mem = pred["memory"]
    check(mem["argument_size_in_bytes"] == held,
          f"{prefix} b. predicted argument bytes "
          f"{mem['argument_size_in_bytes']:.0f} != {held} held on the card")
    bundle.fn(state, batch)                     # builds the live model
    torch.cuda.synchronize()
    best = None
    for _attempt in range(3):       # a trace now and then drops events
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_flops=True) as prof:
            bundle.fn(state, batch)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        flops = product_flops(prof)
        want = pred["roofline"]["hlo_flops"]
        rel = flops["launched"] / want - 1 if want else float("inf")
        if best is None or abs(rel) < abs(best[0]):
            best = (rel, flops, peak)
        if abs(rel) <= DRYRUN["flop_tol"]:
            break
    rel, flops, peak = best
    measured = flops["launched"]
    check(abs(rel) <= DRYRUN["flop_tol"],
          f"{prefix} b. profiler product FLOPs {measured} against the "
          f"prediction {want:.0f} ({rel:+.4%}): {flops}")
    traced = pred["trace"]["flops_by_op"]
    peak_pred = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    log(f"{prefix} b. {DRYRUN['arch']} B {shape.global_batch} x S "
        f"{shape.seq_len}, remat_block {cfg.remat_block}, 1x1 mesh: "
        f"predicted argument bytes {mem['argument_size_in_bytes']:.0f} == "
        f"{held} held by the state and batch on the card; dot FLOPs "
        f"predicted {want:.6e} (trace {traced}) against the profiler's "
        f"product events that launched a kernel {measured:.6e} "
        f"({flops['by_op']}), {rel:+.4%}; the profiler also gives "
        f"{flops['aborted']:.6e} to {flops['aborted_events']} product "
        f"events that launched nothing (a checkpoint's recomputation "
        f"stops early, after the op's inputs are saved and before its "
        f"kernel) and {flops['other']:.6e} to elementwise events "
        f"({flops['other_ops']}); predicted peak (arguments + temp) "
        f"{peak_pred / 1e9:.3f} GB, per device "
        f"{mem['per_device_bytes'] / 1e9:.3f} GB, against "
        f"max_memory_allocated {peak / 1e9:.3f} GB in the step (not "
        f"gated); prediction {pred_s:.1f} s [{card}]")
    return {"argument_bytes": held, "flops_pred": want,
            "flops_profiler": measured, "flops_rel": rel, "flops": flops,
            "peak_pred": peak_pred, "peak": peak}


def product_flops(prof) -> dict:
    """The FLOPs of a ``with_flops`` trace: of the product events
    (DRYRUN["products"]) that launched a kernel, by op; of those that
    launched none; and of every other event with FLOPs."""
    out = {"launched": 0, "by_op": {}, "aborted": 0, "aborted_events": 0,
           "other": 0, "other_ops": {}}
    for ev in prof.events():
        if not ev.flops:
            continue
        if ev.name not in DRYRUN["products"]:
            out["other"] += int(ev.flops)
            out["other_ops"][ev.name] = out["other_ops"].get(ev.name, 0) + 1
        elif ev.device_time_total > 0:
            out["launched"] += int(ev.flops)
            out["by_op"][ev.name] = out["by_op"].get(ev.name, 0) + int(
                ev.flops)
        else:
            out["aborted"] += int(ev.flops)
            out["aborted_events"] += 1
    return out


def _bitwise(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8),
        b.reshape(-1).contiguous().view(torch.uint8))


def dryrun_logical(prefix: str, card, setup) -> dict:
    """c: the full-width state and batch placed on 4 logical devices of
    the card, a (2, 2) ("data", "model") mesh, through ``sharding_tree``:
    each id's shard bytes the dry run's per-device argument bytes, the
    shards gathered back bitwise, one leaf at a time."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import logical_devices, make_local_mesh
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    cfg, recipe, shape, state, _bundle, batch = setup
    with logical_devices(DRYRUN["logical"], DEVICE):
        mesh = make_local_mesh(DRYRUN["model_axis"], device=DEVICE)
    want = dryrun.argument_bytes(cfg, recipe, shape, mesh)
    rules = shd.make_rules(mesh, cfg, fsdp=recipe["fsdp"],
                           global_batch=shape.global_batch)
    shardings = {"state": steps.state_shardings(cfg, mesh, rules),
                 "batch": shd.batch_sharding(mesh, rules, mode="train")}
    held = dict.fromkeys(range(mesh.size), 0)
    leaves = 0
    for t, s in dryrun._pairs({"state": state, "batch": batch}, shardings):
        parts = s.shard(t)
        check(all(p.device == t.device for p in parts.values()),
              f"{prefix} c. shards off the card")
        for i, p in parts.items():
            held[i] += p.numel() * p.element_size()
        check(_bitwise(s.gather(parts), t),
              f"{prefix} c. the gather of a {tuple(t.shape)} leaf "
              f"({s.spec}) is not the leaf")
        leaves += 1
        del parts
    torch.cuda.empty_cache()
    check(all(v == want for v in held.values()),
          f"{prefix} c. shard bytes per device id {held} != the dry run's "
          f"{want:.0f}")
    log(f"{prefix} c. the state and batch ({leaves} leaves) on "
        f"{mesh.size} logical devices of the card, mesh "
        f"{dict(mesh.shape)}: every id holds {want / 1e9:.4f} GB, equal to "
        f"the dry run's per-device argument bytes; every leaf gathered "
        f"back bitwise [{card}]")
    return {"bytes_per_device": want, "leaves": leaves}


def phase_main_dryrun(card) -> dict:
    """[main-dryrun]: the dry run (launch/dryrun.py on meta) and its
    prediction held to the card (DRYRUN); none of the 12 entry points
    launches."""
    import torch
    from repro_torch.kernels import launcher
    prefix = "[main-dryrun]"
    t_phase = time.perf_counter()
    launcher.reset_launch_counts()
    secs, out = {}, {}
    t0 = time.perf_counter()
    out["a"] = dryrun_cells(prefix, card)
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    setup = _train_setup()
    out["b"] = dryrun_one_device(prefix, card, setup)
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["c"] = dryrun_logical(prefix, card, setup)
    secs["c"] = time.perf_counter() - t0
    del setup
    torch.cuda.empty_cache()
    launches = launcher.entry_launch_counts()
    check(not any(launches.values()), f"{prefix} launched {launches}")
    phase_s = time.perf_counter() - t_phase
    log(f"{prefix} {phase_s:.1f}s in all ("
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items())
        + f"); none of the 12 entry points launched [{card}]")
    return {"launches": launches, **out, "phase_s": phase_s,
            "part_s": secs}


def span_clock():
    """time.monotonic rounded to 2^-20 s: differences and sums of its
    readings are exact in float64, so that a request's spans can be held
    to their shared endpoints with ==."""
    return round(time.monotonic() * 2 ** 20) / 2 ** 20


def async_requests(sizes, count: int, seed: int, tiers=None) -> list:
    """``count`` requests of ASYNC["rows"] rows cycling over the graphs
    (and over ``tiers``; None: bank requests)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        gid = i % len(sizes)
        x = rng.standard_normal((ASYNC["rows"], sizes[gid])).astype(
            np.float32)
        out.append((gid, x, None if tiers is None else tiers[i % len(tiers)],
                    tiers is None))
    return out


def timed_load(svc, requests) -> tuple:
    """(results, requests/s) of one closed-loop load."""
    from repro_torch.launch.service import closed_loop_load
    t0 = time.perf_counter()
    results = closed_loop_load(svc, requests, workers=ASYNC["workers"])
    rate = len(requests) / (time.perf_counter() - t0)
    check(all(r is not None for r in results), "a request got no answer")
    return results, rate


def warm(svc, requests) -> None:
    """Answer one request per (graph, tier) group, then zero the SLO
    counters: first calls are not in the measured load."""
    from repro_torch.launch.service import closed_loop_load
    seen, first = set(), []
    for req in requests:
        if (req[0], req[2]) not in seen:
            seen.add((req[0], req[2]))
            first.append(req)
    closed_loop_load(svc, first, workers=ASYNC["workers"])
    sync()
    svc.reset_stats()


def hold_answers(tag, routes, requests, results, h, family: str) -> dict:
    """Every answer against ``step_versioned`` (``step_bank_versioned``)
    of its engine on that request's rows alone, zero-padded as the
    service pads them, at the same tier and version; uncounted.  Returns
    the largest max|dy| and whether every answer was bitwise equal."""
    import torch
    from repro_torch.launch.service import quantize_rows
    worst, scale = [], 1.0
    with uncounted():
        for (gid, x, tier, bank), res in zip(requests, results):
            route = routes[gid]
            eng = route.engine
            b, n = int(eng.basis.spectrum.shape[0]), eng.basis.n
            r, size = x.shape
            block = torch.zeros((b, quantize_rows(r), n), device=DEVICE)
            block[route.row, :r, :size] = torch.from_numpy(x).to(DEVICE)
            if bank:
                y, v = eng.step_bank_versioned(block)
                want = y[route.row, :, :r, :size]
            else:
                y, v = eng.step_versioned(block, h, tier=tier)
                want = y[route.row, :r, :size]
            check(v == res.version, f"[{tag}] graph {gid}: answered by "
                  f"version {res.version}, reference at {v}")
            got = torch.from_numpy(res.y).to(DEVICE)
            check(got.shape == want.shape, f"[{tag}] graph {gid}: answer "
                  f"{tuple(got.shape)} != {tuple(want.shape)}")
            worst.append((got - want).abs().max())
            scale = max(scale, float(want.abs().max()))
        err = float(torch.stack(worst).max())
    tol = 0.0 if family == "general" else TOL
    check(err <= tol * scale, f"[{tag}] answers vs step_versioned on the "
          f"request alone: max|dy| {err:.3e} > {tol} * {scale:.3e}")
    return {"max_abs_err": err, "bitwise": err == 0.0, "scale": scale}


def check_spans(tag, results) -> None:
    """Each request's queue, batch and execute spans share their
    endpoints with the next one and with the request span, exactly."""
    from repro_torch import obs
    by_id: dict = {}
    for s in obs.default_tracer().spans(cat="serve"):
        if s["trace_id"] is not None:
            by_id.setdefault(s["trace_id"], {})[s["name"]] = s
    for res in results:
        sp = by_id.get(res.trace_id, {})
        check(len(sp) == 4, f"[{tag}] request {res.trace_id}: spans "
              f"{sorted(sp)}")
        q, bt, ex, tot = (sp["request/queue"], sp["request/batch"],
                          sp["request/execute"], sp["request"])
        check(q["ts"] == tot["ts"] and q["ts"] + q["dur"] == bt["ts"]
              and bt["ts"] + bt["dur"] == ex["ts"]
              and ex["ts"] + ex["dur"] == tot["ts"] + tot["dur"]
              and q["dur"] + bt["dur"] + ex["dur"] == tot["dur"]
              == res.total_s and ex["dur"] == res.service_s,
              f"[{tag}] request {res.trace_id}: spans do not share their "
              f"endpoints: {q}, {bt}, {ex}, {tot}")


def slo_text(stats) -> str:
    """p50/p99 of queue, service and total per tier, in ms."""
    lat = stats["latency"]
    tiers = sorted({k.split("/")[0] for k in lat})
    return "; ".join(
        f"{t}: " + ", ".join(
            f"{stage} p50 {lat[f'{t}/{stage}']['p50_s'] * 1e3:.3f} / p99 "
            f"{lat[f'{t}/{stage}']['p99_s'] * 1e3:.3f} ms"
            for stage in ("queue", "service", "total")) for t in tiers)


def one_launch_per_dispatch(tag, counts, stats, entry) -> None:
    check(counts[entry] == stats["dispatches"] > 0
          and sum(counts.values()) == counts[entry],
          f"[{tag}] {stats['dispatches']} fused dispatches but launches "
          f"{ {k: v for k, v in counts.items() if v} }")


def kernel_streams(prof) -> dict:
    """kernel name -> the CUDA streams its launches ran on, from the
    profiler's Chrome trace."""
    import os
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json", dir=ROOT / "build")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)
    out: dict = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            stream = ev.get("args", {}).get("stream", ev.get("tid"))
            out.setdefault(ev["name"], set()).add(stream)
    return out


def traced_streams(fn, want: tuple, traces: int = 3, before=None) -> dict:
    """``kernel_streams`` of a profiled call of fn, from the first of up
    to ``traces`` traces that holds a launch of a kernel named in
    ``want`` (a trace now and then drops events); ``before(attempt)``
    runs ahead of each, outside the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for attempt in range(traces):
        if before is not None:
            before(attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        streams = kernel_streams(prof)
        if any(w in k for k in streams for w in want):
            return streams
        seen.append({k[:60]: sorted(v) for k, v in streams.items()})
    raise SmokeFailure(f"no trace of {traces} holds a launch of {want}; "
                       f"kernels and streams per trace: {seen}")


def maintenance_streams(ckpt) -> dict:
    """Child of [main-async] d, in a fresh process: a dynamic engine on the
    [main] basis saved in ``ckpt`` (and its Laplacians, ``laps.npy``)
    behind a service whose maintainer ticks only when asked; the CUDA
    streams of 32 served requests, then of one REFRESH tick, each from a
    torch.profiler trace (``traced_streams``).  The tick runs after a
    quiet tick and one round of updates at DYNAMIC["forced_churn"].
    Launches here are in no count of the parent's."""
    from dataclasses import replace
    import numpy as np
    from repro_torch.core import ApproxEigenbasis
    from repro_torch.dynamic import GraphStream, RefitPolicy
    from repro_torch.graphs import community_graph
    from repro_torch.kernels import build, launcher
    from repro_torch.launch import serve
    from repro_torch.launch.service import AsyncFGFTService
    build.library()
    ckpt = pathlib.Path(ckpt)
    basis = ApproxEigenbasis.load(ckpt, device=DEVICE)
    graphs = int(basis.spectrum.shape[0])
    stream = GraphStream([community_graph(basis.n, seed=s)
                          for s in range(graphs)])
    laps = np.stack(stream.laplacians())
    check(np.array_equal(laps, np.load(ckpt / "laps.npy")),
          "[main-async streams] the stream differs from [main]'s Laplacians")
    policy = RefitPolicy(refresh=ASYNC["refresh"], extend=1e9, refit=1e9,
                         hysteresis=1.0, max_extends=1000)
    tiers = serve.parse_tiers(MAIN["tiers"])
    dyn = serve.FGFTServeEngine(laps, basis=basis, tiers=tiers,
                                dynamic=True, policy=policy, device=DEVICE)
    x_one = [(g, x, "full", False) for g, x, _, _ in
             async_requests([basis.n] * graphs, 32, 65, sorted(tiers))]
    attempts, launched = [], {}

    def refresh_ready(attempt):
        # a quiet tick (every threshold out of reach) clears a hysteresis
        # floor an earlier tick left armed; then one round of updates
        attempts.append(attempt)
        dyn.controller.policy = replace(policy, refresh=1e9)
        svc.maintain_now(timeout=120)
        dyn.controller.policy = policy
        update_round(dyn, stream, DYNAMIC["forced_churn"],
                     90000 + 1000 * attempt)
        sync()

    def refresh_tick():
        launcher.reset_launch_counts()
        check(svc.maintain_now(timeout=120)["action"] == "refresh",
              "[main-async streams] the profiled tick was not a REFRESH")
        launched.clear()
        launched.update({k: v for k, v in
                         launcher.entry_launch_counts().items() if v})

    with AsyncFGFTService(dyn, h=lowpass, name="smoke-streams",
                          max_queue=ASYNC["max_queue"],
                          max_batch=ASYNC["max_batch"]) as svc:
        warm(svc, x_one)
        serving = traced_streams(lambda: timed_load(svc, x_one),
                                 ("g_operator_kernel",))
        maintenance = traced_streams(
            refresh_tick, ("g_chain_kernel", "g_operator_kernel"),
            traces=6, before=refresh_ready)
    return {"serving": {k: sorted(v) for k, v in serving.items()},
            "maintenance": {k: sorted(v) for k, v in maintenance.items()},
            "launched": launched, "attempt": len(attempts)}


def phase_main_async(errs, main, main_dir) -> dict:
    """[main-async]: the async front end (launch/service.py) on the tables
    the earlier phases fitted, each part driven with the counts zeroed
    just before and read just after (comparisons not counted).  a. the
    [main] basis with its tiers and the F = 7 bank behind
    ``AsyncFGFTService(max_queue=128, max_batch=8)``: 2048 tier requests
    and 512 bank requests of R = 8 rows from 16 closed-loop tenants,
    every answer against ``step_versioned`` on the request alone, one
    kernel launch per fused dispatch, compile spans equal to plan-cache
    misses, each request's spans sharing their endpoints exactly; the
    same tier load untraced (``obs.configure(enabled=False)``) for the
    traced/untraced ratio.  b. the [main-directed] basis, 512 requests
    bitwise.  c. [main-ragged]'s saved router, 512 requests over its
    three buckets, pads 0 in every bucket output.  d. a dynamic engine on
    the [main] basis under a churn thread, 2048 requests while the
    maintainer ticks on its own CUDA stream: swaps, non-decreasing
    versions, no failed request, the final full tier against plain, a
    profiled tick's kernels on another stream than the serving launches
    (``maintenance_streams``, in a child process), p99 while a tick runs
    against idle.  e. ``serve --fgft --serve-async
    --dynamic --trace T --metrics-dir M`` at a small size."""
    from collections import Counter
    import shutil
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.dynamic import GraphStream, RefitPolicy
    from repro_torch.dynamic.refit import Action
    from repro_torch.graphs import community_graph
    from repro_torch.kernels import launcher
    from repro_torch.kernels.plan import (ApplyPlan, clear_plan_cache,
                                          plan_cache_stats)
    from repro_torch.launch import serve
    from repro_torch.launch.service import AsyncFGFTService
    t_phase = time.perf_counter()
    counts: Counter = Counter()
    tracer = obs.default_tracer()
    tiers = sorted(serve.parse_tiers(MAIN["tiers"]))
    svc_args = dict(max_queue=ASYNC["max_queue"],
                    max_batch=ASYNC["max_batch"], clock=span_clock)

    def driven(fn):
        launcher.reset_launch_counts()
        out = fn()
        sync()
        seen = launcher.entry_launch_counts()
        counts.update(seen)
        return out, seen

    # a. static, undirected, full width: compile spans count from a
    # cleared plan cache, so the engine is built after the clear
    clear_plan_cache()
    tracer.clear()
    m_out = main["out"]
    engine = serve.FGFTServeEngine(
        m_out["laps"], basis=m_out["engine"].basis,
        tiers=serve.parse_tiers(MAIN["tiers"]), filters=MAIN["filters"],
        device=DEVICE)
    sizes = [engine.basis.n] * int(engine.basis.spectrum.shape[0])
    reqs = async_requests(sizes, ASYNC["requests"], 61, tiers)
    bank_reqs = async_requests(sizes, ASYNC["bank_requests"], 62)
    with AsyncFGFTService(engine, h=lowpass, name="smoke-static",
                          **svc_args) as svc:
        warm(svc, reqs)
        (results, rate), seen = driven(lambda: timed_load(svc, reqs))
        stats = svc.stats()
        one_launch_per_dispatch("main-async", seen, stats,
                                "batched_sym_operator_apply")
        check(stats["served"] == len(reqs) and stats["errors"] == 0,
              f"[main-async] served {stats['served']}, errors "
              f"{stats['errors']}")
        check_spans("main-async", results)
        obs.configure(enabled=False)
        try:
            svc.reset_stats()
            _, rate_off = timed_load(svc, reqs)
        finally:
            obs.configure(enabled=True)
        warm(svc, bank_reqs)
        (bank_results, bank_rate), bank_seen = driven(
            lambda: timed_load(svc, bank_reqs))
        bank_stats = svc.stats()
        one_launch_per_dispatch("main-async bank", bank_seen, bank_stats,
                                "batched_sym_filter_bank_apply")
        check_spans("main-async bank", bank_results)
    compiles = len(tracer.spans(cat="compile"))
    misses = plan_cache_stats()["misses"]
    check(compiles == misses > 0, f"[main-async] {compiles} compile spans, "
          f"{misses} plan-cache misses")
    routes = svc._routes
    held = hold_answers("main-async", routes, reqs, results, lowpass, "sym")
    bank_held = hold_answers("main-async bank", routes, bank_reqs,
                             bank_results, None, "sym")
    errs["batched_sym_operator_apply"] = max(
        errs["batched_sym_operator_apply"], held["max_abs_err"])
    errs["batched_sym_filter_bank_apply"] = max(
        errs["batched_sym_filter_bank_apply"], bank_held["max_abs_err"])
    log(f"[main-async] {len(reqs)} tier requests (R = {ASYNC['rows']}, "
        f"{ASYNC['workers']} tenants, max_batch {ASYNC['max_batch']}): "
        f"{rate:.1f} requests/s traced, {rate_off:.1f} untraced (traced/"
        f"untraced {rate / rate_off:.4f}); {stats['dispatches']} fused "
        f"dispatches = {seen['batched_sym_operator_apply']} operator "
        f"launches, mean occupancy {stats['batch']['occupancy_mean']:.3f}"
        f" (max {stats['batch']['occupancy_max']}), queue peak "
        f"{stats['queue']['peak']}; {slo_text(stats)}")
    log(f"[main-async] {len(bank_reqs)} bank requests (F = "
        f"{len(engine.bank)}): {bank_rate:.1f} requests/s, "
        f"{bank_stats['dispatches']} dispatches = "
        f"{bank_seen['batched_sym_filter_bank_apply']} bank launches, mean "
        f"occupancy {bank_stats['batch']['occupancy_mean']:.3f}; "
        f"{slo_text(bank_stats)}")
    log(f"[main-async] answers vs step_versioned on the request alone: "
        f"tiers max|dy| {held['max_abs_err']:.3e} (bitwise "
        f"{held['bitwise']}), bank {bank_held['max_abs_err']:.3e} (bitwise "
        f"{bank_held['bitwise']}); compile spans {compiles} = plan-cache "
        f"misses {misses}; every request's spans share their endpoints")

    # b. directed: the [main-directed] basis, held bitwise
    d_out = main_dir["out"]
    d_engine = serve.FGFTServeEngine(
        d_out["laps"], basis=d_out["engine"].basis,
        tiers=serve.parse_tiers(MAIN["tiers"]), device=DEVICE)
    d_reqs = async_requests(sizes, ASYNC["directed_requests"], 63, tiers)
    with AsyncFGFTService(d_engine, h=lowpass, name="smoke-directed",
                          **svc_args) as svc:
        warm(svc, d_reqs)
        (d_results, d_rate), d_seen = driven(lambda: timed_load(svc,
                                                                d_reqs))
        d_stats = svc.stats()
        one_launch_per_dispatch("main-async directed", d_seen, d_stats,
                                "batched_gen_operator_apply")
    d_held = hold_answers("main-async directed", svc._routes, d_reqs,
                          d_results, lowpass, "general")
    log(f"[main-async directed] {len(d_reqs)} requests: {d_rate:.1f} "
        f"requests/s, {d_stats['dispatches']} dispatches, every answer "
        f"bitwise equal to step_versioned on the request alone; "
        f"{slo_text(d_stats)}")

    # c. ragged: [main-ragged]'s saved router, loaded (no fit)
    router = serve.RaggedFGFTServeEngine.load(
        ROOT / "build" / "ragged_checkpoint", device=DEVICE)
    outputs = []
    for w, eng in router.engines.items():
        def keep(live, x, h, tier, _step=eng._step_on, _eng=eng):
            y = _step(live, x, h, tier)
            outputs.append((_eng, y))
            return y
        eng._step_on = keep
    r_reqs = async_requests(router.sizes, ASYNC["ragged_requests"], 64,
                            tiers)
    with AsyncFGFTService(router, h=lowpass, name="smoke-ragged",
                          **svc_args) as svc:
        warm(svc, r_reqs)
        outputs.clear()
        (r_results, r_rate), r_seen = driven(lambda: timed_load(svc,
                                                                r_reqs))
        r_stats = svc.stats()
        one_launch_per_dispatch("main-async ragged", r_seen, r_stats,
                                "batched_sym_operator_apply")
    for eng in router.engines.values():
        del eng._step_on
    with uncounted():
        for eng, y in outputs:
            if eng.basis.sizes is None:         # a bucket without pads
                continue
            pad = (torch.arange(eng.basis.n, device=DEVICE)
                   >= torch.as_tensor(eng.basis.sizes,
                                      device=DEVICE)[:, None])
            check(bool((y.masked_select(pad[:, None, :]) == 0).all()),
                  "[main-async ragged] a bucket output has nonzero pads")
    r_held = hold_answers("main-async ragged", svc._routes, r_reqs,
                          r_results, lowpass, "sym")
    log(f"[main-async ragged] {len(r_reqs)} requests over buckets "
        f"{sorted(router.engines)}: {r_rate:.1f} requests/s, "
        f"{r_stats['dispatches']} dispatches ({len(outputs)} bucket "
        f"outputs, pads 0 in each); answers vs step_versioned max|dy| "
        f"{r_held['max_abs_err']:.3e} (bitwise {r_held['bitwise']}); "
        f"{slo_text(r_stats)}")

    # d. dynamic: churn and maintenance on the maintainer's own stream
    policy = RefitPolicy(refresh=ASYNC["refresh"], extend=1e9, refit=1e9,
                         hysteresis=1.0, max_extends=1000)
    dyn = serve.FGFTServeEngine(
        m_out["laps"], basis=m_out["engine"].basis,
        tiers=serve.parse_tiers(MAIN["tiers"]), dynamic=True, policy=policy,
        device=DEVICE)
    stream = GraphStream([community_graph(MAIN["n"], seed=s)
                          for s in range(len(sizes))])
    check(np.array_equal(np.stack(stream.laplacians()), m_out["laps"]),
          "[main-async dynamic] the stream differs from [main]'s Laplacians")
    ticks = []
    real_maintain, real_execute = dyn.maintain, dyn._execute
    churn_stop = threading.Event()

    def timed_maintain():
        t0 = span_clock()
        res = real_maintain()
        ticks.append((t0, span_clock(), res["action"]))
        return res

    def one_extend(action, laps):
        # at most one full-width EXTEND (~5 s) in the phase: the churn
        # stops when the first starts
        if action is Action.EXTEND:
            churn_stop.set()
        return real_execute(action, laps)

    dyn.maintain, dyn._execute = timed_maintain, one_extend
    churn_errors = []

    def churn(svc):
        try:
            rnd = 0
            while not churn_stop.is_set():
                update_round(dyn, stream, ASYNC["churn"],
                             20000 + 1000 * rnd)
                svc.request_maintain()
                rnd += 1
                churn_stop.wait(ASYNC["maintain_interval"])
        except Exception as exc:  # noqa: BLE001 — re-raised after join
            churn_errors.append(exc)

    y_reqs = async_requests(sizes, ASYNC["dynamic_requests"], 65, tiers)
    try:
        with AsyncFGFTService(dyn, h=lowpass, name="smoke-dynamic",
                              maintain_interval=ASYNC["maintain_interval"],
                              **svc_args) as svc:
            warm(svc, y_reqs)
            churner = threading.Thread(target=churn, args=(svc,),
                                       name="smoke-churn")
            launcher.reset_launch_counts()
            churner.start()
            try:
                y_results, y_rate = timed_load(svc, y_reqs)
            finally:
                churn_stop.set()
                churner.join(60)
            check(not churner.is_alive() and not churn_errors,
                  f"[main-async dynamic] churn failed: {churn_errors}")
            y_stats = svc.stats()
            svc.maintain_now(timeout=120)       # absorb the last updates
            sync()
            counts.update(launcher.entry_launch_counts())
    finally:
        dyn.maintain, dyn._execute = real_maintain, real_execute
    acted = Counter(a for _, _, a in ticks)
    check(y_stats["errors"] == 0 and y_stats["maintain"]["errors"] == 0
          and y_stats["maintain"]["swaps"] >= 1 and acted["extend"] <= 1,
          f"[main-async dynamic] stats {y_stats['maintain']}, errors "
          f"{y_stats['errors']}, ticks {dict(acted)}")
    ids = {r.trace_id for r in y_results}
    order = sorted((s["ts"] + s["dur"], s["args"]["version"])
                   for s in tracer.spans(name="request")
                   if s["trace_id"] in ids)
    versions = [v for _, v in order]
    check(len(versions) == len(y_results) and versions == sorted(versions),
          "[main-async dynamic] versions decrease in dispatch order")
    # streams: in a process of its own on the same [main] tables
    # (maintenance_streams); this process's profiler lost a tick's kernels
    # after the earlier phases' hundreds of traces
    ckpt = ROOT / "build" / "async_streams"
    shutil.rmtree(ckpt, ignore_errors=True)
    m_out["engine"].basis.save(ckpt)
    np.save(ckpt / "laps.npy", m_out["laps"])
    child = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"),
         "--maintenance-streams", str(ckpt)],
        capture_output=True, text=True, timeout=300)
    check(child.returncode == 0, f"[main-async dynamic] the stream check "
          f"failed:\n{child.stdout[-2000:]}\n{child.stderr[-4000:]}")
    traced = json.loads(child.stdout.strip().splitlines()[-1])
    serve_streams, maint_streams = traced["serving"], traced["maintenance"]
    serving = set().union(*map(set, serve_streams.values()))
    maint = set().union(*map(set, maint_streams.values()))
    check(maint and not (maint & serving),
          f"[main-async dynamic] maintenance kernels on streams {maint}, "
          f"serving launches on {serving}")
    with uncounted():
        live = dyn._live
        x = torch.from_numpy(np.stack(
            [x for _, x, _, _ in y_reqs[:len(sizes)]])).to(DEVICE)
        plain = ApplyPlan(family="sym", mode="operator", n=dyn.basis.n,
                          batched=True, backend="torch",
                          device=DEVICE).program()
        compare("batched_sym_operator_apply", dyn.step(x, lowpass),
                plain(live.fwd, live.bwd,
                      lowpass(live.tiers["full"]["spectrum"]), x), errs)
    during = {"action": [], "reuse": [], "idle": []}
    spans = {s["trace_id"]: s for s in tracer.spans(name="request")}
    for res in y_results:
        s = spans[res.trace_id]
        t0, t1 = s["ts"], s["ts"] + s["dur"]
        over = {act for a, b, act in ticks if a < t1 and t0 < b}
        key = ("idle" if not over else "reuse" if over == {"reuse"}
               else "action")
        during[key].append(res.total_s)

    def p99(xs):
        if not xs:
            return "none"
        rank = max(int(np.ceil(0.99 * len(xs))), 1)
        return f"{sorted(xs)[rank - 1] * 1e3:.3f} ms ({len(xs)} requests)"

    log(f"[main-async dynamic] {len(y_reqs)} requests under churn "
        f"{ASYNC['churn']}: {y_rate:.1f} requests/s; ticks {dict(acted)}, "
        f"swaps {y_stats['maintain']['swaps']}, versions "
        f"{versions[0]} -> {versions[-1]} non-decreasing in dispatch order, "
        f"no failed request; total p99 while a refresh or extend tick runs "
        f"{p99(during['action'])}, while a reuse tick (drift probe) runs "
        f"{p99(during['reuse'])}, idle {p99(during['idle'])}; "
        f"{slo_text(y_stats)}")
    ours = sorted({name for name in launcher.KERNELS
                   for k in maint_streams if f"{name}(" in k})
    log(f"[main-async dynamic] a profiled REFRESH tick's "
        f"{len(maint_streams)} kernels ({', '.join(ours)} and library "
        f"kernels; the tick's wrappers launched "
        f"{traced['launched']}) on CUDA streams {sorted(maint)}, the serving "
        f"launches on {sorted(serving)} (a process of its own, trace "
        f"{traced['attempt']} of up to 6); final full tier vs plain within "
        f"{TOL} * scale")

    # e. the CLI at a small size
    out_dir = ROOT / "build" / "async_cli"
    shutil.rmtree(out_dir, ignore_errors=True)
    trace_path, metrics_dir = out_dir / "trace.json", out_dir / "metrics"
    argv = ASYNC["cli"] + ["--trace", str(trace_path), "--metrics-dir",
                           str(metrics_dir), "--device", DEVICE]
    cli, _ = driven(lambda: serve.main(argv))
    events = json.loads(trace_path.read_text())["traceEvents"]
    check(any(e["name"] == "request" for e in events),
          "[main-async cli] the trace holds no request span")
    snap = json.loads((metrics_dir / "metrics.json").read_text())
    prom = (metrics_dir / "metrics.prom").read_text()
    for name in ("service_requests_total", "plan_cache_misses_total"):
        check(name in snap and name in prom,
              f"[main-async cli] {name} missing from the metrics files")
    log(f"[main-async cli] serve {' '.join(argv)}: {cli['qps']:.1f} "
        f"requests/s, versions {cli['versions']}; {len(events)} trace "
        f"events, metrics.json/metrics.prom hold service_requests_total "
        f"and plan_cache_misses_total")
    for entry in ("batched_sym_operator_apply",
                  "batched_sym_filter_bank_apply",
                  "batched_gen_operator_apply", "batched_butterfly_apply"):
        check(counts[entry] > 0, f"async path never launched {entry}")
    phase_s = time.perf_counter() - t_phase
    log(f"[main-async] {phase_s:.1f}s in all (budget 90 s); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return {"launches": dict(counts), "rate": rate, "rate_untraced":
            rate_off, "stats": stats, "bank_rate": bank_rate,
            "directed_rate": d_rate, "ragged_rate": r_rate,
            "dynamic_rate": y_rate, "phase_s": phase_s}


#: entry point -> (family, kernel) of the turns phase
TURNS = {"batched_sym_operator_apply": ("sym", "g_operator_kernel"),
         "sym_operator_apply": ("sym", "g_operator_kernel"),
         "batched_gen_operator_apply": ("general", "t_operator_kernel"),
         "gen_operator_apply": ("general", "t_operator_kernel"),
         "batched_butterfly_apply": ("sym", "g_chain_kernel"),
         "butterfly_apply": ("sym", "g_chain_kernel"),
         "batched_shear_apply": ("general", "t_chain_kernel"),
         "shear_apply": ("general", "t_chain_kernel")}


def save_turn_inputs(path, main, single, main_dir, single_dir) -> None:
    """Phase 7's timing inputs of the TURNS entry points, on the host: per
    entry point both table sets, n, the spectrum and the signal (the
    batched G chain's signal is the tier refit's identity block)."""
    import torch
    from repro_torch.core.staging import table_arrays

    def host(staged):
        return [t.cpu() for t in table_arrays(staged)]
    out = {}
    for entry, (family, _) in TURNS.items():
        batched = entry.startswith("batched")
        path_rec = ((main if batched else single) if family == "sym"
                    else (main_dir if batched else single_dir))
        if batched:
            basis = path_rec["out"]["engine"].basis
            x = path_rec["out"]["signals"]
            fwd, bwd, spec = basis.fwd, basis.bwd, basis.spectrum
            if entry == "batched_butterfly_apply":
                x = torch.eye(basis.n).expand(spec.shape[0], basis.n,
                                              basis.n).contiguous()
        else:
            f, x = path_rec["fgft"], path_rec["signals"]
            fwd, bwd, spec = f.fwd, f.bwd, f.spectrum
        out[entry] = {"fwd": host(fwd), "bwd": host(bwd), "n": fwd.n,
                      "diag": spec.cpu(), "x": x.cpu()}
    torch.save(out, path)


def time_entries(path) -> dict:
    """Child of the turns phase: the TURNS entry points of the
    ``repro_torch`` on sys.path, timed on the saved inputs (a chain on
    its forward tables, full chain)."""
    import torch
    from repro_torch.core.staging import StagedG, StagedT
    from repro_torch.kernels import butterfly as bf
    from repro_torch.kernels import shear as sh
    data = torch.load(path)
    out = {}
    for entry, (family, kernel) in TURNS.items():
        d = data[entry]
        cls, mod = (StagedG, bf) if family == "sym" else (StagedT, sh)
        fwd, bwd = (cls(*(t.to(DEVICE) for t in d[leg]), None, d["n"])
                    for leg in ("fwd", "bwd"))
        diag, x = d["diag"].to(DEVICE), d["x"].to(DEVICE)
        fn = getattr(mod, entry)
        if "operator" in kernel:
            call = lambda: fn(fwd, bwd, diag, x)  # noqa: E731
        else:
            call = lambda: fn(fwd, x)  # noqa: E731
        out[entry] = {"ms": time_ms(call), "device_ms": device_ms(call,
                                                                  kernel)}
    return out


def phase_turns(baselines, main, single, main_dir, single_dir) -> list:
    """This checkout's TURNS entry points and each baseline's, timed in
    turns (this, baselines..., then in reverse), each tree in a process
    of its own that builds its own kernels."""
    import os
    work = ROOT / "build" / "turns"
    work.mkdir(parents=True, exist_ok=True)
    inputs = work / "turn_inputs.pt"
    save_turn_inputs(inputs, main, single, main_dir, single_dir)
    trees = [("this", ROOT)] + [(f"baseline {d}", pathlib.Path(d).resolve())
                                for d in baselines]
    rows = []
    for k, (tag, tree) in enumerate(trees + trees[::-1]):
        check((tree / "src" / "repro_torch").is_dir(),
              f"{tree} holds no src/repro_torch")
        env = dict(os.environ, REPRO_TORCH_BUILD_DIR=str(
            work / f"build_{trees.index((tag, tree))}"))
        out = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--time-entries",
             str(inputs), "--src", str(tree / "src")],
            capture_output=True, text=True, env=env, timeout=900)
        check(out.returncode == 0, f"turn {k} ({tag}) failed:\n"
              f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        for entry, r in res.items():
            dev_txt = ("not measured" if r["device_ms"] is None
                       else f"{r['device_ms']:.4f} ms")
            log(f"[turns] {k}: {tag}: {entry} {r['ms']:.4f} ms (device "
                f"{dev_txt})")
        rows.append({"turn": k, "tree": tag, **res})
    return rows


def reuse_g_greedy() -> None:
    """From here on in this process, a G greedy
    (``gtransform._approx_sym_core``) on exactly the inputs of an earlier
    one returns a copy of that one's result instead of running again.
    [main-filter], [main-dynamic] and [main-bf16] fit [main]'s fleet at
    its g and n_iter through their CLIs: each greedy would take 50-90 s
    of a run held to 1200 s.  Packing (a dynamic engine's pinned stage
    quantum included), tiers and all that follows still run per
    engine."""
    import copy
    import hashlib
    import torch
    from repro_torch.core import gtransform as gt
    real = gt._approx_sym_core
    done: dict = {}

    def digest(t):
        if t is None:
            return None
        data = torch.as_tensor(t).detach().cpu().contiguous().numpy()
        return hashlib.sha256(data.tobytes()).hexdigest()

    def core(s_mat, sbar0, g, n_iter, update_spectrum, eps, score,
             size=None):
        key = (tuple(s_mat.shape), digest(s_mat), digest(sbar0), g, n_iter,
               update_spectrum, eps, score, digest(size))
        if key in done:
            log(f"[reuse] G greedy of {tuple(s_mat.shape)} at g = {g}, "
                f"n_iter = {n_iter}: an earlier fit's result, not run again")
        else:
            done[key] = real(s_mat, sbar0, g, n_iter, update_spectrum, eps,
                             score, size)
        return copy.deepcopy(done[key])

    gt._approx_sym_core = core


#: [main-sharded]: the sharded train step on logical devices of the card
#: (a: 2 layers at full width in f32 against the unsharded step, on two
#: meshes; b: the full model, 2 steps; c: the pod step; d: the CLI).  a's
#: lr: AdamW's first update is g / (|g| + eps) x lr, so a summation-order
#: difference of a gradient entry near eps moves the parameter by a part
#: of lr (4.8e-6 apart at lr 1e-4 on the H100, gradients within 1.3e-6
#: of their scale); the parameter bound of 1e-6 holds at lr 1e-5
SHARDED = dict(arch=TRAIN["arch"], logical=4, seq=256, batch=8,
               check=dict(layers=2, meshes=((2, 2), (1, 4)), lr=1e-5),
               full=dict(mesh=(2, 2), steps=2),
               pod=dict(layers=2, meshes=((2, 1, 2), (2, 2, 2)),
                        ratio=0.125, steps=2),
               cli=dict(steps=6, cut=3, model_axis=2),
               loss_tol=1e-6, grad_tol=1e-5, grad_floor=1e-3,
               param_tol=1e-6, own_norm_tol=1e-6)


#: [main-sharded] e: one train step of each family beyond the dense ones
#: on logical devices of the card, f32 (TF32 off), at full width and the
#: smallest depth its layer pattern takes (seamless: as many encoder
#: layers), seed-0 weights drawn leaf by leaf, the cross-attention gates
#: at 0.5 (at their init, 0, the cross-attention weights take no
#: gradient), against the unsharded step on the card with a's bounds;
#: llama-3.2-vision-90b (6.4 B parameters) holds its loss and gradients
#: only, at B 2: AdamW's moments would take the card past its 80 GB.
#: ``f64``: where the unsharded f32 step's own gradients lie farther
#: than a's bound from an f64 step's at this width (mamba2-780m's
#: lm_head 1.31 of it, llama-3.2-vision-90b's leaves 4.50 at d 8192 on
#: an H100: a K = 28672 f32 product alone rounds ~1e-5 of its scale),
#: the gradients are held to a's bound in f64 (the port's f32
#: statistics, softmax and SSD decays stay f32), with these changes to
#: the config (llama: ff and vocabulary cut so that the f64 state fits);
#: the f32 run's gradient reading is printed beside it.  A differing MoE
#: route fails unless that token's top-k margin (the k-th largest router
#: probability less the next) is below ``margin``.  kimi-k2-1t-a32b
#: (ROADMAP A6e): one layer, KIMI's f32 expert cut (``cut``, f32
#: parameters in place of the recipe's bf16) with fsdp (``fsdp``) and
#: expert parallelism on (2, 2), 4 experts a rank, gradients only (both
#: copies share one HBM), its draws rounded to bf16 values (``values``:
#: the recipe's parameters, held in f32), so that ``split_bf16`` can
#: then print C12's distance: the bf16 sharded step's gradients against
#: the unsharded bf16 step's beside twice the unsharded bf16 step's
#: distance from the f32 one.  Then the CLI of mamba2-780m on a model
#: axis of 2, resumed bitwise.
SHARDED_FAMILIES = dict(
    runs=(dict(arch="kimi-k2-1t-a32b", layers=1, mesh=(2, 2), fsdp=True,
               update=False, cut=dict(n_experts=KIMI["experts"]["f32"],
                                      param_dtype="float32"),
               values="bfloat16", split_bf16=True),
          dict(arch="qwen3-moe-30b-a3b", layers=2, mesh=(1, 4)),
          dict(arch="mamba2-780m", layers=2, mesh=(1, 4), f64={}),
          dict(arch="recurrentgemma-2b", layers=3, mesh=(2, 2)),
          dict(arch="seamless-m4t-large-v2", layers=2, mesh=(1, 4)),
          dict(arch="llama-3.2-vision-90b", layers=5, mesh=(1, 4), batch=2,
               update=False, f64=dict(d_ff=8192, vocab=32768))),
    gate=0.5, lr=1e-5, margin=1e-6,
    cli=dict(arch="mamba2-780m", steps=4, cut=2, model_axis=2))


def moved_ratio(got, want, bound) -> float:
    """max over the entries of |got - want| / bound (tensor lists)."""
    return max(float(((g.float() - w.float()).abs() / b).max())
               for g, w, b in zip(got, want, bound))


def _logical_mesh(shape, axes=("data", "model")):
    import numpy as np
    import torch
    from repro_torch.launch.mesh import Mesh, logical_devices, \
        process_devices
    n = int(np.prod(shape))
    with logical_devices(n, DEVICE):
        return Mesh(np.arange(n).reshape(shape), axes,
                    process_devices(torch.device(DEVICE).type))


def _sharded_batch(cfg, seed: int):
    from repro_torch.data.pipeline import SyntheticLM
    return SyntheticLM(cfg, SHARDED["seq"], SHARDED["batch"],
                       seed=seed).batch(0)


def sharded_check(prefix: str, card) -> dict:
    """a: one step of the sharded step against the unsharded step on the
    card, f32 (TF32 off), 2 layers at full width, on a (2, 2) and a
    (1, 4) mesh of logical devices (at 4 the two KV heads are replicated
    and each rank reads the one its three query heads use).  The
    parameters after the step at lr 1e-5 are held entry by entry within
    ``adamw.first_step_tolerance`` of the gradient and norm bounds: a
    bound on the parameters' scale would not see an update of 1e-5, and
    where a gradient entry is near AdamW's eps a rounding difference of
    it moves the update by a part of lr."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    c = SHARDED["check"]
    cfg = get_config(SHARDED["arch"]).replace(n_layers=c["layers"],
                                              dtype=torch.float32)
    hyper = dict(seq_len=SHARDED["seq"], global_batch=SHARDED["batch"],
                 peak_lr=c["lr"], warmup=0, total_steps=10)
    tree = tfm.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        7), DEVICE)
    batch = _sharded_batch(cfg, 7)

    def fresh():
        params = tfm.tree_map(lambda t: t.clone(), tree)
        return steps.TrainState(params, adamw.init(params))

    state = fresh()
    model = tfm.Transformer(cfg, state.params, live=True)
    (loss, _), grads = tfm.value_and_grad(model, cfg, batch)
    want_g = [g.clone() for g in tree_leaves(grads)]
    del model, grads
    plain = steps.make_train_step(cfg, device=DEVICE, **hyper)
    state, want_m = plain.fn(state, batch)
    want_p, want_norm = tree_leaves(state.params), want_m["grad_norm"]
    out = {}
    for shape in c["meshes"]:
        mesh = _logical_mesh(shape)
        bundle = steps.make_train_step(cfg, mesh, **hyper)
        placed = shd.place_tree(fresh(), bundle.state_shardings)
        metrics, g = bundle.fn.gradients(placed, batch)
        g = tfm.tree_map(lambda t: t.clone(), shd.gather_tree(
            g, bundle.state_shardings.params))
        placed, m = bundle.fn(placed, batch)
        got_p = tree_leaves(shd.gather_tree(placed, bundle.state_shardings)
                            .params)
        # the update path alone: the unsharded AdamW of the step's own
        # gradients, its norm added in another order
        own = fresh()
        _, _, om = adamw.update(g, own.opt, own.params, lr=c["lr"])
        got_g, own_p = tree_leaves(g), tree_leaves(own.params)
        r_own = moved_ratio(got_p, own_p, adamw.first_step_tolerance(
            got_g, own_p, om["grad_norm"], lr=c["lr"], grad_tol=0.0,
            norm_tol=SHARDED["own_norm_tol"]))
        del g, own, own_p
        r_loss = abs(float(m["loss"]) - float(loss)) / (
            SHARDED["loss_tol"] * abs(float(loss)))
        r_grad, n = worst_ratio(got_g, want_g, SHARDED["grad_tol"],
                                SHARDED["grad_floor"])
        r_par, _ = worst_ratio(got_p, want_p, SHARDED["param_tol"])
        r_upd = moved_ratio(got_p, want_p, adamw.first_step_tolerance(
            want_g, want_p, want_norm, lr=c["lr"],
            grad_tol=SHARDED["grad_tol"], norm_tol=SHARDED["grad_tol"]))
        r_norm = abs(float(m["grad_norm"]) - float(want_norm)) / (
            SHARDED["grad_tol"] * float(want_norm))
        log(f"{prefix} a. {SHARDED['arch']} (f32, {c['layers']} layers at "
            f"full width, B {SHARDED['batch']} x S {SHARDED['seq']}, TF32 "
            f"off) on a {'x'.join(map(str, shape))} mesh of logical devices "
            f"against the unsharded step: loss {float(m['loss']):.7f} vs "
            f"{float(loss):.7f}; max|d| / bound: loss {r_loss:.3e} (bound "
            f"{SHARDED['loss_tol']} relative), {n} gradient leaves "
            f"{r_grad:.3e} ({SHARDED['grad_tol']} x max("
            f"{SHARDED['grad_floor']}, max|g|)), the global norm "
            f"{r_norm:.3e} ({SHARDED['grad_tol']} relative), parameters "
            f"after one AdamW update at lr {c['lr']} {r_upd:.3e} "
            f"(adamw.first_step_tolerance of those gradient and norm "
            f"bounds), and against the unsharded AdamW of the step's own "
            f"gradients {r_own:.3e} (the same, no gradient term, the norm "
            f"{SHARDED['own_norm_tol']} relative); not gated: the "
            f"parameters against {SHARDED['param_tol']} x max(1, max|p|) "
            f"{r_par:.3e} [{card}]")
        check(max(r_loss, r_grad, r_norm, r_upd, r_own) <= 1.0,
              f"{prefix} a. {shape}: sharded vs unsharded over the bound "
              f"({r_loss}, {r_grad}, {r_norm}, {r_upd}, {r_own})")
        out["x".join(map(str, shape))] = {"loss": r_loss, "grads": r_grad,
                                          "norm": r_norm, "params": r_upd,
                                          "update": r_own,
                                          "params_scale": r_par}
        del placed, bundle, got_g, got_p
        torch.cuda.empty_cache()
    return out


def sharded_full(prefix: str, card, trained) -> dict:
    """b: the full model on a (2, 2) mesh of 4 logical devices: 2 steps,
    the state placed by ``placed_train_state``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_recipe
    from repro_torch.configs.shapes import Shape
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import dryrun
    from repro_torch.runtime import hlo_analysis as hlo
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    c = SHARDED["full"]
    cfg = get_config(SHARDED["arch"])
    recipe = get_recipe(SHARDED["arch"])
    mesh = _logical_mesh(c["mesh"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bundle = steps.make_train_step(
        cfg, mesh, seq_len=SHARDED["seq"], global_batch=SHARDED["batch"],
        fsdp=recipe["fsdp"], moment_dtype=recipe["moment_dtype"], warmup=2,
        total_steps=c["steps"])
    state = steps.placed_train_state(
        bundle, torch.Generator(device=DEVICE).manual_seed(0))
    pipe = SyntheticLM(cfg, SHARDED["seq"], SHARDED["batch"], seed=0)
    losses, step_ms = [], []
    for k in range(c["steps"]):
        batch = pipe.batch(k)
        bundle.collectives.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = bundle.fn(state, batch)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    coll = bundle.collectives.by_id()
    terms = hlo.collective_terms(bundle.collectives)
    t_rep = time.perf_counter()
    rep = dryrun.collective_count(cfg, recipe, Shape(
        "main-sharded", SHARDED["seq"], SHARDED["batch"], "train"), mesh,
        batch=batch).by_id()
    rep_s = time.perf_counter() - t_rep
    held = shd.placed_nbytes(state)
    placed_batch = shd.placed_nbytes(shd.place_tree(
        {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()},
        bundle.batch_shardings))
    want = dryrun.argument_bytes(cfg, recipe, Shape(
        "main-train", SHARDED["seq"], SHARDED["batch"], "train"), mesh)
    n_kernels, busy_ms, wall_ms = kernel_trace(
        lambda: bundle.fn(state, batch), 1, host=False)
    med = statistics.median(step_ms[1:])
    log(f"{prefix} b. {SHARDED['arch']} at full size ({cfg.n_layers} "
        f"layers, remat_block {cfg.remat_block}, {str(cfg.dtype)[6:]}), "
        f"B {SHARDED['batch']} x S {SHARDED['seq']} on a "
        f"{'x'.join(map(str, c['mesh']))} mesh of {mesh.size} logical "
        f"devices of one card: losses {[round(v, 4) for v in losses]}; "
        f"median step {med:.1f} ms (steps 2-{c['steps']}, first "
        f"{step_ms[0]:.1f} ms) against [main-train]'s unsharded "
        f"{trained['a']['step_ms']:.1f} ms; one step {n_kernels:.0f} kernel "
        f"launches, device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
        f"(torch.profiler); max_memory_allocated {peak / 2 ** 30:.2f} GiB "
        f"[{card}]")
    per_id = {i: held[i] + placed_batch[i] for i in held}
    log(f"{prefix} b. state and batch bytes per id {per_id} against the "
        f"dry run's argument_size_in_bytes {want:.0f} for this mesh "
        f"[{card}]")
    log(f"{prefix} b. one step's collective result bytes per id by kind "
        f"and axes {coll}; per device (JAX's measure: an all-reduce "
        f"twice) {terms['collective_bytes']} B, "
        f"{terms['collective_counts']} ops, {terms['collective_s']:.4e} s "
        f"at NVLink's {hlo.NVLINK_BW / 1e9:.0f} GB/s a direction "
        f"(reckoned: logical devices move nothing over a link) [{card}]")
    log(f"{prefix} b. the representative count (one id of the mesh traced "
        f"on meta, every id counted as it) equal id by id, kind by kind "
        f"and axes by axes to the step's count on the card: "
        f"{rep == coll}; trace {rep_s:.1f} s [{card}]")
    check(all(np.isfinite(losses)), f"{prefix} b. losses {losses}")
    check(set(per_id.values()) == {want},
          f"{prefix} b. bytes per id {per_id} != {want}")
    check(rep == coll, f"{prefix} b. representative count {rep} != the "
          f"card's {coll}")
    out = {"losses": losses, "step_ms": med, "first_ms": step_ms[0],
           "launches_a_step": n_kernels, "busy_ms": busy_ms,
           "wall_ms": wall_ms, "peak": peak, "bytes_per_id": want,
           "collectives": coll, "collective_bytes":
           terms["collective_bytes"], "representative_s": rep_s}
    del state, bundle
    torch.cuda.empty_cache()
    return out


def pod_cross_bytes(bundle, compressed: bool = True) -> int:
    """One pod step's cross-pod result bytes on an id, counted from the
    leaves' shard shapes (an all-reduce twice, as JAX counts it): each
    leaf's compact block (ceil(n / width) x keep f32) or, below the
    compressor's 2^14 entries a shard, its f32 shard; the pods' mean of
    ``loss`` and ``ppl_proxy``; the global norm's scalar, added over the
    whole mesh.  ``compressed`` False: every shard whole (the bytes an
    uncompressed cross-pod reduction would move)."""
    from repro_torch.optim.adamw import tree_leaves
    spec = bundle.fn.spec
    total = 0
    for meta, sh in zip(tree_leaves(bundle.abstract_state.params),
                        tree_leaves(bundle.state_shardings.params)):
        n = 1
        for d in sh.shard_shape(meta.shape):
            n *= d
        small = n < 1 << 14 or not compressed
        total += n if small else -(-n // spec.width) * spec.keep
    return 2 * 4 * (total + 2 + 1)


def sharded_pod(prefix: str, card) -> dict:
    """c: the cross-pod compressed step at full width, 2 layers, on a
    (2, 1, 2) ("pod", "data", "model") mesh of 4 logical devices and on
    the JAX test's (2, 2, 2) of 8.  Gated on each: finite losses, the
    cross-pod bytes equal to the count from the leaves' shard shapes and
    under half of what the uncompressed reduction would move across the
    pods; on (2, 2, 2) also the JAX test's gate, under half of all the
    collective bytes (on (2, 1, 2) printed: with a data axis of 1 the
    pod's only other collectives are the model axis's activation sums)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime import hlo_analysis as hlo
    from repro_torch.runtime import steps
    c = SHARDED["pod"]
    cfg = get_config(SHARDED["arch"]).replace(n_layers=c["layers"])
    out = {}
    for shape in c["meshes"]:
        mesh = _logical_mesh(shape, ("pod", "data", "model"))
        bundle = steps.make_pod_compressed_train_step(
            cfg, mesh, seq_len=SHARDED["seq"],
            global_batch=SHARDED["batch"], compress_ratio=c["ratio"],
            warmup=1, total_steps=c["steps"])
        state = steps.placed_train_state(
            bundle, torch.Generator(device=DEVICE).manual_seed(2))
        pipe = SyntheticLM(cfg, SHARDED["seq"], SHARDED["batch"], seed=2)
        losses = []
        t0 = time.perf_counter()
        for k in range(c["steps"]):
            state, metrics = bundle.fn(state, pipe.batch(k))
            losses.append(float(metrics["loss"]))
        ms = (time.perf_counter() - t0) * 1e3 / c["steps"]
        terms = hlo.collective_terms(bundle.collectives)
        want = c["steps"] * pod_cross_bytes(bundle)
        whole = c["steps"] * pod_cross_bytes(bundle, compressed=False)
        cross, total = terms["cross_pod_bytes"], terms["collective_bytes"]
        tag = "x".join(map(str, shape))
        jax_gate = shape[1] > 1
        log(f"{prefix} c. pod step, {SHARDED['arch']} at full width, "
            f"{c['layers']} layers, {tag} (pod, data, model) mesh of "
            f"{mesh.size} logical devices, compress_ratio {c['ratio']}, "
            f"{c['steps']} steps: losses {[round(v, 4) for v in losses]}, "
            f"{ms:.1f} ms a step; cross_pod_bytes {cross}, counted from the "
            f"leaves' shard shapes {want}, uncompressed {whole} ("
            f"{cross / whole:.4f}; gate < 0.5); of collective_bytes {total} "
            f"{cross / total:.4f} (the JAX test's gate < 0.5: "
            f"{'gated' if jax_gate else 'not gated at a data axis of 1'}) "
            f"[{card}]")
        check(all(np.isfinite(losses)), f"{prefix} c. {tag} losses {losses}")
        check(cross == want, f"{prefix} c. {tag} cross-pod bytes {cross} != "
              f"{want}")
        check(0 < cross < 0.5 * whole, f"{prefix} c. {tag} cross-pod "
              f"{cross} of {whole} uncompressed")
        if jax_gate:
            check(cross < 0.5 * total, f"{prefix} c. {tag} cross-pod "
                  f"{cross} of {total}")
        out[tag] = {"losses": losses, "cross_pod_bytes": cross,
                    "uncompressed": whole, "collective_bytes": total,
                    "ms": ms}
        del state, bundle
        torch.cuda.empty_cache()
    return out


def sharded_cli(prefix: str, card, arch: str = SHARDED["arch"],
                c: dict = SHARDED["cli"], part: str = "d") -> dict:
    """d: ``train --smoke --model-axis 2`` on 4 logical devices of the
    card: 3 steps, ``--resume auto`` to 6, against 6 at once (e: another
    ``arch``'s, at ``c``'s steps)."""
    import shutil
    import torch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import logical_devices
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import sharding as shd
    root = ROOT / "build" / "train_sharded"
    shutil.rmtree(root, ignore_errors=True)

    def run(name, n, *extra):
        argv = ["--arch", arch, "--smoke", "--steps", str(n),
                "--seq-len", "32", "--global-batch", "4", "--log-every",
                "3", "--model-axis", str(c["model_axis"]), "--device",
                DEVICE, "--ckpt-dir", str(root / name), *extra]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed), \
                logical_devices(SHARDED["logical"], DEVICE):
            out = train.run(train.parse_args(argv))
        return out, printed.getvalue()

    run("a", c["cut"])
    resumed, text = run("a", c["steps"], "--resume", "auto")
    whole, _ = run("b", c["steps"])
    shutil.rmtree(root)
    check(f"resumed from step {c['cut']} (saved on {SHARDED['logical']} "
          "devices)" in text, f"{prefix} {part}. no resume line")
    got, want = (tree_leaves(shd.gather_tree(r["state"],
                                             r["bundle"].state_shardings))
                 for r in (resumed, whole))
    same = [torch.equal(a, b) for a, b in zip(got, want)]
    log(f"{prefix} {part}. train --arch {arch} --smoke --model-axis "
        f"{c['model_axis']} on "
        f"{SHARDED['logical']} logical devices (mesh "
        f"{dict(resumed['mesh'].shape)}): {c['cut']} steps, --resume auto "
        f"to {c['steps']}, against {c['steps']} at once: final loss "
        f"{resumed['final_loss']:.6f} vs {whole['final_loss']:.6f}, "
        f"{sum(same)} of {len(same)} state leaves bitwise [{card}]")
    check(all(same) and len(got) == len(want)
          and resumed["final_loss"] == whole["final_loss"],
          f"{prefix} {part}. the resumed run differs from the uninterrupted "
          "one")
    return {"resumed": resumed["final_loss"], "whole": whole["final_loss"]}


class HostPark:
    """One block of pinned host memory that part e parks the unsharded
    step's results in, each family's in turn: an H100 host copies to and
    from pinned memory at ~47 GB/s and to pageable memory at ~1.8 GB/s
    (pinning costs ~1 s a 4 GB, once)."""

    ALIGN = 64

    def __init__(self, nbytes: int):
        import torch
        self.block = torch.empty(nbytes, dtype=torch.uint8,
                                 pin_memory=DEVICE == "cuda")
        self.used = 0

    @classmethod
    def need(cls, leaves, itemsize: int, copies: int = 1) -> int:
        """Bytes of ``copies`` parked copies of tensors of these shapes."""
        import math
        return copies * sum(-(-math.prod(shape) * itemsize // cls.ALIGN)
                            * cls.ALIGN for shape in leaves)

    def clear(self) -> None:
        """Start over: what was parked must not be read again."""
        self.used = 0

    def park(self, t):
        """A copy of ``t`` in the block."""
        n = t.numel() * t.element_size()
        view = self.block[self.used:self.used + n].view(t.dtype).view(
            t.shape)
        self.used += -(-n // self.ALIGN) * self.ALIGN
        return view.copy_(t)


class RouterInputs:
    """Keeps each MoE block's last normed input (``MoEBlock.project``'s
    ``h``) while open, to read the router's top-k margin of a token whose
    route differs."""

    def __enter__(self):
        from repro_torch.models.blocks import MoEBlock
        self.inputs, self._project = {}, MoEBlock.project

        def project(block, h, first=0):
            self.inputs[id(block)] = h.detach()
            return self._project(block, h, first)

        MoEBlock.project = project
        return self

    def __exit__(self, *exc):
        from repro_torch.models.blocks import MoEBlock
        MoEBlock.project = self._project

    def margins(self, model) -> list:
        """Each MoE block's top-k margin per token, (groups, gsz)."""
        import torch
        from repro_torch.models.blocks import MoEBlock, moe_groups
        out = []
        for m in model.modules():
            if isinstance(m, MoEBlock):
                h = self.inputs[id(m)]
                gsz, _ = moe_groups(m.cfg, *h.shape[:2])
                probs = torch.softmax((h.reshape(-1, gsz, h.shape[-1])
                                       @ m.router.to(h.dtype)).float(), -1)
                top = probs.sort(-1, descending=True).values
                k = m.cfg.top_k
                out.append((top[..., k - 1] - top[..., k]).cpu())
        return out


def family_step(prefix: str, card, run: dict, park: HostPark) -> dict:
    """e, one family: the unsharded step's loss, gradients (and with an
    update its global norm and parameters after AdamW) moved to host
    memory, then the sharded step on ``run``'s mesh of logical devices
    from the same weights, each leaf gathered and held to its host copy
    one at a time.  Also: every id holds the dry run's argument bytes
    (the state's shards and the batch, the memory counted in bf16 as the
    dry run's input specs give it; without an update the moments are
    reckoned from their shardings, not allocated), the collective result
    bytes per id by kind and axes, the peak device bytes, the host bytes
    the check holds, and for an MoE the routes and kept pairs against
    the unsharded step's.  ``park``: the pinned block the results are
    parked in."""
    import torch
    from repro_torch.configs.shapes import Shape
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import hlo_analysis as hlo
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    c = SHARDED_FAMILIES
    t0 = time.perf_counter()
    arch, update = run["arch"], run.get("update", True)
    cfg = family_config(run)
    seq, rows = SHARDED["seq"], run.get("batch", SHARDED["batch"])
    hyper = dict(seq_len=seq, global_batch=rows, peak_lr=c["lr"], warmup=0,
                 total_steps=10)
    specs = steps.input_specs(cfg, seq, rows)
    batch = {k: torch.from_numpy(v).to(specs[k].dtype) for k, v in
             SyntheticLM(cfg, seq, rows, seed=0).batch(0).items()}
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    tree = family_tree(cfg, run)
    n_params = sum(t.numel() for t in tree_leaves(tree))
    with RouterInputs() as spy:
        model = tfm.Transformer(cfg, tree, live=True)
        (loss, _), grads = tfm.value_and_grad(model, cfg, batch)
        routes, kept = moe_routes(model), [m.cpu() for m in moe_kept(model)]
        margins = spy.margins(model)
    park.clear()
    want_g = [park.park(g) for g in tree_leaves(grads)]
    want_p = None
    if update:   # the rest of the unsharded step's calls, in place
        opt = adamw.init(tree)
        _, _, om = adamw.update(grads, opt, tree, lr=adamw.warmup_cosine(
            opt.step, peak_lr=c["lr"], warmup=0, total=10))
        want_norm = float(om["grad_norm"])
        want_p = [park.park(p) for p in tree_leaves(tree)]
        del opt
    else:
        want_norm = sum(float(torch.linalg.vector_norm(g)) ** 2
                        for g in tree_leaves(grads)) ** 0.5
    del model, grads
    t_plain = time.perf_counter() - t0
    host = sum(t.numel() * t.element_size() for t in want_g + (want_p or []))
    mesh = _logical_mesh(run["mesh"])
    fsdp = run.get("fsdp", False)
    bundle = steps.make_train_step(cfg, mesh, fsdp=fsdp, **hyper)
    ids, sh = bundle.fn.ids, bundle.state_shardings
    if update:   # the update wrote ``tree``: the same draws, leaf by leaf
        del tree
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        placed = steps.placed_train_state(
            bundle, torch.Generator(device=DEVICE).manual_seed(0))
        for st in placed.values():
            open_gates(st.params, c["gate"])
    else:
        params = shd.place_tree(tree, sh.params)
        del tree
        placed = {i: steps.TrainState(params[i], None) for i in ids}
        del params
    run_fn, got = bundle.fn, {}
    if update:   # one step, its gradients kept as it reduced them
        def gradients(state, bt, inner=run_fn.gradients):
            got["g"] = inner(state, bt)
            return got["g"]

        run_fn.gradients = gradients
        bundle.collectives.reset()
        placed, m = run_fn(placed, batch)
        del run_fn.gradients   # the class's method again (no cycle)
        metrics, g = got.pop("g")
        step_norm = float(m["grad_norm"])
    else:
        bundle.collectives.reset()
        metrics, g = run_fn.gradients(placed, batch)
    coll = bundle.collectives.by_id()
    terms = hlo.collective_terms(bundle.collectives)
    got_loss = float(metrics[ids[0]]["loss"])
    model = run_fn.live[ids[0]][1]
    got_routes = moe_routes(model)
    got_kept = [m.cpu() for m in moe_kept(model)]
    del model
    # the first id routes its data shard's rows: the unsharded call's
    # first dispatch groups (a shard holds whole groups)
    routes, kept, margins = ([r[:len(x)] for r, x in zip(v, got_routes)]
                             for v in (routes, kept, margins))
    held = shd.placed_nbytes(placed)
    # the checks read the gradients and, after an update, the parameters:
    # the moments (and without an update the parameters) go first
    after = {i: placed[i].params for i in ids} if update else None
    del placed
    run_fn.live.clear()
    r_upd, each = None, None
    if update:   # each parameter after the step, held beside its gradient
        shardings = tree_leaves(sh.params)
        per_id = {i: tree_leaves(after[i]) for i in ids}
        upd = []

        def each(k, gw):
            got = shardings[k].gather({i: per_id[i][k] for i in ids})
            pw = want_p[k].to(got.device)
            bound = adamw.first_step_tolerance(
                [gw], [pw], want_norm, lr=c["lr"],
                grad_tol=SHARDED["grad_tol"], norm_tol=SHARDED["grad_tol"])
            upd.append(moved_ratio([got], [pw], bound))

    r_grad, worst, got_norm = gradient_ratio(sh.params, g, ids, want_g, each)
    n_leaves = len(want_g)
    del g, after
    r_loss = abs(got_loss - float(loss)) / (SHARDED["loss_tol"]
                                            * abs(float(loss)))
    r_norm = abs(got_norm - want_norm) / (SHARDED["grad_tol"] * want_norm)
    if update:
        r_upd = max(upd)
        r_norm = max(r_norm, abs(step_norm - want_norm) / (
            SHARDED["grad_tol"] * want_norm))
        del per_id
    if not update:   # the moments and step, reckoned from their shardings
        abstract = bundle.abstract_state
        extra = sum(s.shard_nbytes(t) for t, s in zip(
            tree_leaves(abstract.opt), tree_leaves(sh.opt)))
        held = {i: b + extra for i, b in held.items()}
    placed_batch = shd.placed_nbytes(shd.place_tree(
        batch, bundle.batch_shardings))
    per_id_bytes = {i: held[i] + placed_batch[i] for i in ids}
    t_sharded = time.perf_counter() - t0 - t_plain
    want_bytes = dryrun.argument_bytes(
        cfg, {"fsdp": fsdp, "moment_dtype": torch.float32},
        Shape("sharded-e", seq, rows, "train"), mesh)
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    del bundle, run_fn
    flips = [(a != b).any(-1) for a, b in zip(got_routes, routes)]
    n_flip = sum(int(f.sum()) for f in flips)
    n_kept = sum(int((a != b).sum()) for a, b in zip(got_kept, kept))
    flip_margins = [float(x) for f, mg in zip(flips, margins)
                    for x in mg[f].tolist()]
    secs = time.perf_counter() - t0
    tag = "x".join(map(str, run["mesh"]))
    log(f"{prefix} e. {arch} (f32, {cfg.n_layers} layers"
        f"{f' + {cfg.n_enc_layers} encoder layers' if cfg.is_encdec else ''}"
        f" at full width{run_cuts(run)}, {n_params} parameters, "
        f"B {rows} x S {seq}, TF32 off, gates {c['gate']}) on a {tag} mesh "
        f"of logical devices against the unsharded step: loss "
        f"{got_loss:.7f} vs {float(loss):.7f}; max|d| / bound: loss "
        f"{r_loss:.3e} ({SHARDED['loss_tol']} relative), "
        f"{n_leaves} gradient leaves {r_grad:.3e} (at {worst}) "
        f"({SHARDED['grad_tol']} x max({SHARDED['grad_floor']}, max|g|)"
        f"{'; held in f64 below' if 'f64' in run else ''}), "
        f"the global norm {r_norm:.3e} ({SHARDED['grad_tol']} relative)"
        + (f", parameters after one AdamW update at lr {c['lr']} "
           f"{r_upd:.3e} (adamw.first_step_tolerance)" if update
           else ", no update (loss and gradients only)")
        + f"; {secs:.1f} s (the unsharded step and its host copies "
        f"{t_plain:.1f} s, the sharded step and the leaf checks "
        f"{t_sharded:.1f} s, the dry run's trace "
        f"{secs - t_plain - t_sharded:.1f} s) [{card}]")
    log(f"{prefix} e. {arch}: state and batch bytes per id {per_id_bytes} "
        f"against the dry run's argument bytes {want_bytes}"
        f"{'' if update else ' (moments and step reckoned)'}; peak device "
        f"bytes {peak} (max_memory_allocated; {base} of them allocated "
        f"before the family), host bytes held by the check "
        f"{host}; one {'step' if update else 'gradient pass'}'s collective "
        f"result bytes per id by "
        f"kind and axes {coll}, per device (an all-reduce twice) "
        f"{terms['collective_bytes']} B [{card}]")
    if routes:
        log(f"{prefix} e. {arch}: MoE routes differing from the unsharded "
            f"step's {n_flip} of the first id's "
            f"{sum(r.shape[0] * r.shape[1] for r in routes)} tokens "
            f"(their top-k margins {flip_margins}), kept pairs differing "
            f"{n_kept} [{card}]")
    del want_g, want_p
    exact = (family_exact(prefix, card, run, seq, rows, park)
             if "f64" in run else None)
    split = (split_bf16(prefix, card, run, seq, rows, park)
             if run.get("split_bf16") else None)
    r_held = exact["grads"] if exact else r_grad
    check(max(r_loss, r_held, r_norm, r_upd or 0.0) <= 1.0,
          f"{prefix} e. {arch} {tag}: sharded vs unsharded over the bound "
          f"({r_loss}, {r_held}, {r_norm}, {r_upd})")
    check(set(per_id_bytes.values()) == {want_bytes},
          f"{prefix} e. {arch}: bytes per id {per_id_bytes} != {want_bytes}")
    check(all(mg < c["margin"] for mg in flip_margins),
          f"{prefix} e. {arch}: {n_flip} routes differ, margins "
          f"{flip_margins}")
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"loss": r_loss, "grads": r_grad, "f64": exact,
            "split_bf16": split, "norm": r_norm,
            "params": r_upd, "bytes_per_id": want_bytes, "peak": peak,
            "base": base,
            "host_bytes": host, "collectives": coll,
            "collective_bytes": terms["collective_bytes"],
            "route_flips": n_flip, "kept_flips": n_kept, "seconds": secs,
            "n_params": n_params}


def gradient_ratio(shardings, g, ids, wants, each=None) -> tuple:
    """Each gradient leaf of a sharded step (``g``: id -> its tree of
    shards) gathered and held to its copy in ``wants`` (host tensors in
    ``tree_leaves`` order), one leaf at a time: (max over the leaves of
    max|d| / (a's gradient bound), the worst leaf's path, the gathered
    gradients' global norm).  ``each(k, want)``: called with leaf k's
    copy on the device, before the next leaf."""
    import torch
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.steps import _leaf_paths
    ratio, worst, sq = 0.0, None, 0.0
    per_id = {i: tree_leaves(g[i]) for i in ids}
    for k, ((path, s), want) in enumerate(zip(_leaf_paths(shardings),
                                              wants)):
        got = s.gather({i: per_id[i][k] for i in ids})
        w = want.to(got.device)
        sq += float(torch.linalg.vector_norm(got)) ** 2
        r = float((got - w).abs().max()) / (
            SHARDED["grad_tol"] * max(SHARDED["grad_floor"],
                                      float(w.abs().max())))
        if r >= ratio:
            ratio, worst = r, ".".join(path)
        del got
        if each is not None:
            each(k, w)
        del w
    return ratio, worst, sq ** 0.5


def family_config(run: dict, f64: bool = False, dtype="float32"):
    """A part e run's config: full width at ``run``'s depth (as many
    encoder layers) with ``run["cut"]``'s changes, computed in ``dtype``
    (f32); ``f64``: f64 with ``run["f64"]``'s changes."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(run["arch"])
    cut = {k: getattr(torch, v) if k.endswith("dtype") else v
           for k, v in run.get("cut", {}).items()}
    cfg = cfg.replace(n_layers=run["layers"], dtype=getattr(torch, dtype),
                      n_enc_layers=run["layers"] if cfg.is_encdec else 0,
                      **cut)
    if f64:
        cfg = cfg.replace(dtype=torch.float64, param_dtype=torch.float64,
                          **run["f64"])
    return cfg


def park_bytes(runs) -> int:
    """The pinned bytes part e's largest parking takes: a run's
    gradients (and with an update its parameters), its f64 gradients, or
    its f32 and bf16 gradients (``split_bf16``)."""
    from repro_torch.models import transformer as tfm
    need = 0
    for run in runs:
        parkings = [(False, [(4, 1 + run.get("update", True))])]
        if "f64" in run:
            parkings.append((True, [(8, 1)]))
        if run.get("split_bf16"):   # the f32 and the bf16 gradients
            parkings.append((False, [(4, 1), (2, 1)]))
        for f64, parts in parkings:
            shapes = []
            tfm.tree_map(lambda leaf: shapes.append(leaf.shape),
                         tfm.param_spec(family_config(run, f64)))
            need = max(need, sum(HostPark.need(shapes, size, copies)
                                 for size, copies in parts))
    return need


def run_cuts(run: dict) -> str:
    """A part e run's cuts and layout, as its line names them."""
    out = "".join(f", {k} {v}" for k, v in run.get("cut", {}).items())
    if run.get("fsdp"):
        out += ", fsdp"
    if run.get("values"):
        out += f", values rounded to {run['values']}"
    return out


def family_tree(cfg, run: dict):
    """A part e run's parameters: seed 0 on the card, the cross-attention
    gates opened, each leaf rounded to ``run["values"]`` where given."""
    import torch
    from repro_torch.models import transformer as tfm
    tree = open_gates(tfm.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE),
        SHARDED_FAMILIES["gate"])
    if run.get("values"):
        dt = getattr(torch, run["values"])
        tfm.tree_map(lambda t: t.copy_(t.to(dt)), tree)
    return tree


#: split_bf16's serve steps: the batch, the prompt and the decode steps
SPLIT_SERVE = dict(batch=4, prompt=32, decode=2)


def split_bf16(prefix: str, card, run: dict, seq: int, rows: int,
               park: HostPark) -> dict:
    """e, C12 on the card: from the same values, the unsharded steps in
    f32 and in bf16 (the recipe's: bf16 parameters and compute): the
    train step's loss and gradients (parked), a prompt's prefill and
    decode steps' logits (SPLIT_SERVE; the cache in the compute dtype);
    then the bf16 sharded train, prefill and decode steps on ``run``'s
    mesh.  Each sharded reading beside twice the unsharded bf16 step's
    distance from the f32 one (the bound of
    ``tests/test_torch_bf16_partials.py``), printed, not gated.
    Distances: the loss, relative; gradients, max over leaves of max|d|
    / max(1e-3, max|g|); logits, max over the calls of max|d| / max(1,
    max|logits|)."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    t0 = time.perf_counter()
    floor = SHARDED["grad_floor"]

    def dist(got, want, least=floor) -> float:
        return float((got.float() - want.float()).abs().max()) / max(
            least, float(want.float().abs().max()))

    cfg32 = family_config(run)
    cfg16 = family_config(run, dtype="bfloat16").replace(
        param_dtype=torch.bfloat16)
    host = SyntheticLM(cfg32, seq, rows, seed=0).batch(0)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    b, s, n = (SPLIT_SERVE[k] for k in ("batch", "prompt", "decode"))
    toks = np.random.default_rng(0).integers(
        0, cfg32.vocab, (b, s + n)).astype(np.int32)
    calls = [{"tokens": toks[:, :s]}] + [
        {"token": toks[:, t:t + 1], "pos": np.full((b,), t, np.int32)}
        for t in range(s, s + n)]
    park.clear()
    wants, losses, logits = {}, {}, {}
    for name, cfg in (("f32", cfg32), ("bf16", cfg16)):
        tree = tfm.tree_map(lambda t: t.to(cfg.param_dtype),
                            family_tree(cfg32, run))
        model = tfm.Transformer(cfg, tree, live=True)
        (loss, _), grads = tfm.value_and_grad(model, cfg, batch)
        losses[name] = float(loss)
        wants[name] = [park.park(g) for g in tree_leaves(grads)]
        del model, grads
        model = tfm.Transformer(cfg, tree)
        cache = tfm.init_cache(cfg, b, s + n, DEVICE, cfg.dtype)
        logits[name] = [model.prefill(cache, calls[0]["tokens"])[0]] + [
            model.decode_step(cache, c["token"], c["pos"])[0]
            for c in calls[1:]]
        del model, cache
        if name == "bf16":   # the sharded steps' parameters
            params = tree
        del tree
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    d = {"loss": abs(losses["bf16"] - losses["f32"]) / abs(losses["f32"]),
         "grads": max(dist(x.to(DEVICE), y.to(DEVICE))
                      for x, y in zip(wants["bf16"], wants["f32"])),
         "logits": max(dist(x, y, 1.0) for x, y in zip(logits["bf16"],
                                                        logits["f32"]))}
    mesh = _logical_mesh(run["mesh"])
    fsdp = run.get("fsdp", False)
    bundle = steps.make_train_step(cfg16, mesh, seq_len=seq,
                                   global_batch=rows, fsdp=fsdp)
    placed = shd.place_tree(params, bundle.state_shardings.params)
    placed = {i: steps.TrainState(placed[i], None) for i in placed}
    metrics, g = bundle.fn.gradients(placed, batch)
    ratio, _, _ = gradient_ratio(bundle.state_shardings.params, g,
                                 bundle.fn.ids, wants["bf16"])
    got = {"loss": abs(float(metrics[bundle.fn.ids[0]]["loss"])
                       - losses["bf16"]) / abs(losses["bf16"]),
           # a's bound is grad_tol x the scale
           "grads": ratio * SHARDED["grad_tol"]}
    del placed, bundle, g, wants, metrics
    kw = dict(seq_len=s + n, global_batch=b, fsdp=fsdp)
    pre = steps.make_prefill_step(cfg16, mesh, **kw)
    dec = steps.make_decode_step(cfg16, mesh, **kw)
    weights = shd.place_tree(params, pre.state_shardings[0])
    del params
    cache = shd.place_tree(tfm.init_cache(cfg16, b, s + n, DEVICE,
                                          cfg16.dtype),
                           pre.state_shardings[1])
    got["logits"] = 0.0
    for k, c in enumerate(calls):
        step = pre if k == 0 else dec
        out, cache = step.fn(weights, cache, c)
        got["logits"] = max(got["logits"], dist(
            step.fn.out_sharding.gather(out), logits["bf16"][k], 1.0))
    del weights, cache, pre, dec, logits
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    tag = "x".join(map(str, run["mesh"]))
    log(f"{prefix} e. {run['arch']} C12 in bf16 (bf16 parameters and "
        f"compute{run_cuts(run).replace(', param_dtype float32', '')}; "
        f"serve: B {b}, a prompt of {s} and {n} decode steps, a bf16 "
        f"cache): the {tag} sharded steps against the unsharded bf16 "
        f"ones, beside the unsharded bf16 steps' distance from the f32 "
        f"ones (the bound, twice that): "
        + ", ".join(f"{k} {got[k]:.3e} ({d[k]:.3e}, bound {2 * d[k]:.3e})"
                    for k in ("loss", "grads", "logits"))
        + f" (the loss relative, a gradient leaf max|d| / max({floor}, "
        f"max|g|), logits max|d| / max(1, max|logits|)), printed, not "
        f"gated; {secs:.1f} s [{card}]")
    return {"sharded": got, "unsharded_vs_f32": d,
            "bound": {k: 2 * v for k, v in d.items()}, "seconds": secs}


def family_exact(prefix: str, card, run: dict, seq: int, rows: int,
                 park: HostPark) -> dict:
    """e, a family's gradients in f64 (``run["f64"]``: the config's
    changes): the unsharded step's, parked in host memory, then the
    sharded step's on the same mesh, each leaf held to a's bound."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    t0 = time.perf_counter()
    cfg = family_config(run, f64=True)
    specs = steps.input_specs(cfg, seq, rows)
    batch = {k: torch.from_numpy(v).to(specs[k].dtype) for k, v in
             SyntheticLM(cfg, seq, rows, seed=0).batch(0).items()}
    tree = family_tree(cfg, run)
    model = tfm.Transformer(cfg, tree, live=True)
    (loss, _), grads = tfm.value_and_grad(model, cfg, batch)
    park.clear()
    want = [park.park(t) for t in tree_leaves(grads)]
    del model, grads
    bundle = steps.make_train_step(cfg, _logical_mesh(run["mesh"]),
                                   seq_len=seq, global_batch=rows,
                                   fsdp=run.get("fsdp", False))
    params = shd.place_tree(tree, bundle.state_shardings.params)
    del tree
    placed = {i: steps.TrainState(params[i], None) for i in params}
    del params
    metrics, g = bundle.fn.gradients(placed, batch)
    ids = bundle.fn.ids
    ratio, worst, _ = gradient_ratio(bundle.state_shardings.params, g, ids,
                                     want)
    got = float(metrics[ids[0]]["loss"])
    r_loss = abs(got - float(loss)) / (SHARDED["loss_tol"]
                                       * abs(float(loss)))
    del placed, bundle, g, want
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"{prefix} e. {run['arch']} in f64 ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, ff {cfg.d_ff}, vocab {cfg.vocab}; the "
        f"port's f32 statistics, softmax and SSD decays stay f32) on the "
        f"same mesh against the unsharded step in f64: loss {got!r} vs "
        f"{float(loss)!r}, max|d| / bound: loss {r_loss:.3e}, gradient "
        f"leaves {ratio:.3e} (at {worst}) ({SHARDED['grad_tol']} x max("
        f"{SHARDED['grad_floor']}, max|g|)); {secs:.1f} s [{card}]")
    check(max(r_loss, ratio) <= 1.0, f"{prefix} e. {run['arch']} f64: "
          f"sharded vs unsharded over the bound ({r_loss}, {ratio})")
    return {"loss": r_loss, "grads": ratio, "worst": worst, "seconds": secs}


def sharded_families(prefix: str, card) -> dict:
    """e: ``family_step`` for each of SHARDED_FAMILIES' runs, then the
    CLI of mamba2-780m on a model axis of 2 resumed bitwise."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = SHARDED_FAMILIES
    t0 = time.perf_counter()
    park = HostPark(park_bytes(c["runs"]))
    log(f"{prefix} e. {park.block.numel()} B of pinned host memory for the "
        f"unsharded steps' results, pinned in "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    out = {f"{r['arch']} {'x'.join(map(str, r['mesh']))}":
           family_step(prefix, card, r, park) for r in c["runs"]}
    del park
    out["cli"] = sharded_cli(prefix, card, c["cli"]["arch"], c["cli"], "e")
    return out


#: [main-sharded] f: the sharded prefill and decode steps on logical
#: devices of the card, f32 (TF32 off), an f32 cache, seed-0 weights:
#: qwen2-1.5b at full size on two meshes (at 4 its two KV heads are
#: replicated) and recurrentgemma-2b at full width, 3 layers (one rrl
#: super-layer), at batch 1 on (2, 2), where the batch is smaller than
#: the data shards (``seq_shard``: each local-attention cache's 2048
#: slots split over "data"); its prompt is longer than the window, so
#: the ring buffer wraps.  Logits and every cache leaf within ``tol`` x
#: max(1, max|x|) of the unsharded steps'; each call's collective count
#: equal to its representative trace's.
SHARDED_SERVE = dict(
    runs=(dict(arch=TRAIN["arch"], mesh=(2, 2), batch=8, prompt=256,
               decode=3),
          dict(arch=TRAIN["arch"], mesh=(1, 4), batch=8, prompt=256,
               decode=3),
          dict(arch="recurrentgemma-2b", layers=3, mesh=(2, 2), batch=1,
               prompt=2112, decode=3)),
    tol=1e-4)


def serve_ratio(got, want) -> float:
    """max|got - want| / (SHARDED_SERVE's tol x max(1, max|want|))."""
    return float((got.float() - want.float()).abs().max()) / (
        SHARDED_SERVE["tol"] * max(1.0, float(want.float().abs().max())))


def sharded_serve(prefix: str, card) -> dict:
    """f: each of SHARDED_SERVE's runs: a prompt and its decode steps
    through the unsharded steps on the card, then through
    ``make_prefill_step`` / ``make_decode_step`` on the run's mesh of
    logical devices; the logits gathered over the batch shards and the
    cache gathered leaf by leaf against the unsharded ones; the
    prefill's and the first decode step's collective counts against the
    representative trace's."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_recipe
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    out = {}
    for run in SHARDED_SERVE["runs"]:
        gc.collect()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg = get_config(run["arch"]).replace(dtype=torch.float32)
        if "layers" in run:
            cfg = cfg.replace(n_layers=run["layers"])
        b, s, n = run["batch"], run["prompt"], run["decode"]
        length = s + n
        toks = np.random.default_rng(0).integers(
            0, cfg.vocab, (b, length)).astype(np.int32)
        tree = tfm.init_params(cfg, torch.Generator(
            device=DEVICE).manual_seed(0), DEVICE)
        model = tfm.Transformer(cfg, tree)
        cache = tfm.init_cache(cfg, b, length, DEVICE, torch.float32)
        batches = [{"tokens": toks[:, :s]}] + [
            {"token": toks[:, t:t + 1], "pos": np.full((b,), t, np.int32)}
            for t in range(s, length)]
        wants = [model.prefill(cache, batches[0]["tokens"])[0]]
        wants += [model.decode_step(cache, bt["token"], bt["pos"])[0]
                  for bt in batches[1:]]
        sync()
        t_plain = time.perf_counter() - t0
        del model
        mesh = _logical_mesh(run["mesh"])
        recipe = get_recipe(run["arch"])
        kw = dict(seq_len=length, global_batch=b, fsdp=recipe["fsdp"])
        pre = steps.make_prefill_step(cfg, mesh, **kw)
        dec = steps.make_decode_step(cfg, mesh, **kw)
        params = shd.place_tree(tree, pre.state_shardings[0])
        del tree
        placed = shd.place_tree(tfm.init_cache(cfg, b, length, DEVICE,
                                               torch.float32),
                                pre.state_shardings[1])
        ratios, counts, call_ms = [], [], []
        for k, bt in enumerate(batches):
            step = pre if k == 0 else dec
            step.collectives.reset()
            sync()
            t1 = time.perf_counter()
            got, placed = step.fn(params, placed, bt)
            got = step.fn.out_sharding.gather(got)
            sync()
            call_ms.append((time.perf_counter() - t1) * 1e3)
            ratios.append(serve_ratio(got, wants[k]))
            if k < 2:
                counts.append(step.collectives.by_id())
        r_cache = max(serve_ratio(g, w) for g, w in zip(
            tree_leaves(shd.gather_tree(placed, dec.state_shardings[1])),
            tree_leaves(cache)))
        seq = dec.fn.seq_axes
        del params, placed, pre, dec, cache, wants
        t_sharded = time.perf_counter() - t0 - t_plain
        reps, rep_s = [], 0.0
        for mode, bt in (("prefill", batches[0]), ("decode", batches[1])):
            t1 = time.perf_counter()
            reps.append(dryrun.collective_count(
                cfg, recipe, Shape("main-sharded-f", length, b, mode), mesh,
                batch=bt).by_id())
            rep_s += time.perf_counter() - t1
        same = [r == c for r, c in zip(reps, counts)]
        tag = "x".join(map(str, run["mesh"]))
        secs = time.perf_counter() - t0
        log(f"{prefix} f. {run['arch']} (f32, {cfg.n_layers} layers at "
            f"full width, an f32 cache, TF32 off) on a {tag} mesh of "
            f"logical devices, B {b}, a prompt of {s} and {n} decode "
            f"steps{' (seq_shard: the caches split over data)' if seq else ''}"
            f": max|d| / ({SHARDED_SERVE['tol']} x max(1, max|x|)): logits "
            f"{max(ratios):.3e} (prefill {ratios[0]:.3e}, decode "
            f"{max(ratios[1:]):.3e}), cache leaves {r_cache:.3e}; sharded "
            f"call ms {[round(v, 1) for v in call_ms]}; collectives per id "
            f"of the prefill {counts[0].get(0)} and of a decode step "
            f"{counts[1].get(0)}, the representative traces equal id by "
            f"id {same} ({rep_s:.1f} s); {secs:.1f} s (unsharded "
            f"{t_plain:.1f} s, sharded {t_sharded:.1f} s) [{card}]")
        check(max(ratios) <= 1.0 and r_cache <= 1.0,
              f"{prefix} f. {run['arch']} {tag}: sharded serve over the "
              f"bound (logits {ratios}, cache {r_cache})")
        check(all(same), f"{prefix} f. {run['arch']} {tag}: representative "
              f"counts {reps} != the card's {counts}")
        check(bool(seq) == (b == 1), f"{prefix} f. seq_shard {seq}")
        out[f"{run['arch']} {tag}"] = {
            "logits": max(ratios), "cache": r_cache, "call_ms": call_ms,
            "collectives": counts, "seconds": secs,
            "representative_s": rep_s}
    return out


def phase_main_sharded(card, trained) -> dict:
    """[main-sharded]: the sharded train step (SHARDED) on logical devices
    of the card; none of the 12 entry points launches."""
    import torch
    from repro_torch.kernels import launcher
    prefix = "[main-sharded]"
    t_phase = time.perf_counter()
    launcher.reset_launch_counts()
    secs, out = {}, {}
    for part, fn in (("a", sharded_check),
                     ("b", lambda p, c: sharded_full(p, c, trained)),
                     ("c", sharded_pod), ("d", sharded_cli),
                     ("e", sharded_families), ("f", sharded_serve)):
        if part == "e":   # the families' own count of the entry points
            launches = launcher.entry_launch_counts()
            launcher.reset_launch_counts()
        if part == "f":   # the serve steps' own count
            families = launcher.entry_launch_counts()
            launcher.reset_launch_counts()
        t0 = time.perf_counter()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out[part] = fn(prefix, card)
        torch.cuda.empty_cache()
        secs[part] = time.perf_counter() - t0
    serve = launcher.entry_launch_counts()
    check(not any(launches.values()) and not any(families.values())
          and not any(serve.values()),
          f"{prefix} launched {launches}, e {families}, f {serve}")
    phase_s = time.perf_counter() - t_phase
    log(f"{prefix} {phase_s:.1f}s in all ("
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items())
        + f"); none of the 12 entry points launched [{card}]")
    return {"launches": launches, "families_launches": families,
            "serve_launches": serve, **out, "phase_s": phase_s,
            "part_s": secs}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", nargs="+", default=[], metavar="DIR",
                    help="checkouts whose operator and chain entry points "
                    "are timed in turns with this one's (phase 8)")
    ap.add_argument("--time-entries", metavar="FILE",
                    help=argparse.SUPPRESS)
    ap.add_argument("--src", help=argparse.SUPPRESS)
    ap.add_argument("--maintenance-streams", metavar="DIR",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_entries:
        sys.path.insert(0, args.src)
        print(json.dumps(time_entries(args.time_entries)))
        return 0
    if args.maintenance_streams:
        print(json.dumps(maintenance_streams(args.maintenance_streams)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels import autotune
    # the run's own tile cache, empty: every block_b=None launch takes the
    # launcher's geometry until [main-core] records its measurements
    cache = ROOT / "build" / "autotune.json"
    cache.unlink(missing_ok=True)
    os.environ[autotune.CACHE_ENV] = str(cache)
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build()
    reuse_g_greedy()
    errs: dict = {}
    phase_kernels(errs)
    main_rec = phase_main()
    filter_rec = phase_main_filter(errs)
    single = phase_fgft(errs)
    kernels = phase_main_shapes(main_rec, single, errs)
    filter_out = filter_rec["out"]
    kernels += phase_bank_shapes("sym", filter_rec, filter_out["engine"],
                                 filter_out["signals"], single, errs)
    main_dir = phase_main_directed()
    single_dir = phase_fgft_directed(errs)
    kernels += phase_directed_shapes(main_dir, single_dir, errs)
    bank_dir = main_dir["bank"]
    kernels += phase_bank_shapes("general", bank_dir, bank_dir["engine"],
                                 main_dir["out"]["signals"], single_dir, errs)
    ragged = phase_main_ragged(errs)
    dynamic = phase_main_dynamic(errs, main_dir)
    bf16 = phase_main_bf16(errs, main_rec, filter_rec, single, main_dir,
                           single_dir)
    asynch = phase_main_async(errs, main_rec, main_dir)
    bf16x = phase_main_bf16x(errs, main_rec, filter_rec, single, main_dir,
                             single_dir)
    core = phase_main_core(errs, main_rec, filter_rec, single, main_dir,
                           single_dir)
    lm = phase_main_lm(card)
    lm_families = phase_main_lm_families(card)
    trained = phase_main_train(card)
    placed = phase_main_placed(errs, main_rec, main_dir, ragged)
    dry = phase_main_dryrun(card)
    sharded = phase_main_sharded(card, trained)
    # phase 7 for the bf16 forms, then for the bf16-signal forms on f32
    # and on bf16 tables
    for at in (("bf16", bf16["launches"]),
               ("f32", bf16x["launches"], "bf16"),
               ("bf16", bf16x["launches"], "bf16")):
        kernels += phase_main_shapes(main_rec, single, errs, *at)
        kernels += phase_bank_shapes("sym", filter_rec, filter_out["engine"],
                                     filter_out["signals"], single, errs,
                                     *at)
        kernels += phase_directed_shapes(main_dir, single_dir, errs, *at)
        kernels += phase_bank_shapes("general", bank_dir,
                                     bank_dir["engine"],
                                     main_dir["out"]["signals"], single_dir,
                                     errs, *at)
    check(len(kernels) == 4 * len(REPLACES),
          f"{len(kernels)} kernel rows for the four forms (f32 or bf16 "
          f"tables, f32 or bf16 signal) of {len(REPLACES)} entry points")
    ragged_counts = dict(ragged["launches"])
    for entry, k in ragged["bank_launches"].items():
        ragged_counts[entry] += k
    for entry, k in ragged["directed"]["launches"].items():
        ragged_counts[entry] += k
    for row in kernels:
        row["ragged_launches"] = ragged_counts[row["entry"]]
        row["dynamic_launches"] = dynamic["launches"].get(row["entry"], 0)
        row["async_launches"] = asynch["launches"].get(row["entry"], 0)
        row["core_launches"] = core["launches"].get(row["entry"], 0)
        row["lm_launches"] = lm["launches"].get(row["entry"], 0)
        row["lm_families_launches"] = lm_families["launches"].get(
            row["entry"], 0)
        row["train_launches"] = trained["launches"].get(row["entry"], 0)
        row["placed_launches"] = placed["launches"].get(row["entry"], 0)
        row["dryrun_launches"] = dry["launches"].get(row["entry"], 0)
        row["sharded_launches"] = sharded["launches"].get(row["entry"], 0)
        row["sharded_families_launches"] = sharded["families_launches"].get(
            row["entry"], 0)
        row["sharded_serve_launches"] = sharded["serve_launches"].get(
            row["entry"], 0)
        row["max_abs_err"] = errs[row["entry"]]
    if args.baseline:
        turns = phase_turns(args.baseline, main_rec, single, main_dir,
                            single_dir)
        print(json.dumps({"turns": turns}))
    torch.cuda.synchronize()
    log(f"[done] {time.perf_counter() - t_start:.1f}s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
