#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one GPU and hold its kernels against their
plain PyTorch versions.

    python3 chip_smoke.py [--serial]

Phases, one JSON line each with its seconds; any failed check raises
(non-zero exit).  The whole script, the kernels' build included, is to
finish within 1200 s on one H100; the cut depths below are made for that.
After the build (phase 1) the phases run in six worker processes at
once on the one card (``GROUPS``: a CMA-ES step is host-bound, so the
workers share the card's idle time; the sixth trains and serves the LM
families), each group's
lines printed when all have ended, a failed worker stopping the others;
then the kernels line (phase 5) runs alone.  ``--serial`` runs the
groups one after another in one process instead (the phases' seconds
then are their own).

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   and the build of every kernel from ``src/repro_torch/kernels/csrc``;
   ``cuobjdump -sass`` must find FP64 tensor-core instructions (DMMA) in
   the sample kernels (rows 1-4, ``cma_gen_sample``; row 7,
   ``cma_sample``) and the update kernels (row 6, ``cma_gen_update``; row
   8, ``cma_update``: both take their gram from ``gram_gemm.cuh``), and
   wgmma (HGMMA) in flash attention (row 9); the line also gives the FP64
   instructions and all the instructions of row 5's float64 kernel in its
   SASS, per element, that the bounds of rows 3-5 count, and the top SM
   clock they are taken at;
2. each kernel against its plain version on the card, at the shapes of
   phase 3 (S=1, λ=3072, n=1000) and phase 4 (S=1, λ=3072, n=40, with the
   f1 instance's coefficients), two ragged ones (S=3, λ=37, n=45, one
   all-zero-weight slot; S=2, λ=37, n=101, the sample kernels' stream plan
   on unaligned rows) and every shape a bucketed path launches (S=1,
   λ=12, n=1000 of phase 3b; S=1, λ=12·2ᵏ, n=40 for k = 0…7 of phase 4b,
   with the f1 coefficients), float64 (max relative error ≤ 1e-12) and
   float32 (≤ 1e-4); C′ must be exactly symmetric, and a second launch of
   the sample kernels (rows 1-5) and the update kernel on the same inputs
   bit-identical (every partial sum is added in a fixed order), each
   launch on memory that was just filled with NaN.  The in-kernel RNG kernels are fed seed
   words at and above 2³¹, and must be prefix-stable
   kernel against kernel, bit for bit, at n=1000 and n=40: the first 12
   and 192 rows of a λ=3072 call are a λ=12 and a λ=192 call (Z, Y, X
   and F).  At every shape an RNG call (rows 3-4) gives, bit for bit, the
   Z-operand call (rows 1-2) on row 5's Z of the same seeds; where it
   draws Z in the kernel (n ≤ 64) it allocates no Z scratch
   (``torch.cuda.memory_stats`` around a call: no block beyond its
   outputs of S·λ·n elements or more).  The grouped
   sample kernel (row 7, ``cma_sample``) at every
   row layout a strategies path gives it — the K-Distributed heap of
   phase 6 (512 devices × 12 rows, n=1000, nine descents), one descent of
   λ = 12·2ᵏ rows (k = 0…8, n=1000), the K-Replicated groups of phase 6c
   (8 devices × 12 rows, n=1000) and of the small runs of phase 6b (n=8)
   — in both forms (Y, and X = m + σ·Y), each again bit-identical on a
   second launch into NaN-filled memory; the rank-μ update kernel (row 8,
   ``cma_rank_mu_update``) at (λ, n) = (12, 1000), (3072, 1000) and
   (192, 40), directly, with every other weighted row's weight negative,
   with a second slot of zero weights and through ``rank_mu_gram``'s
   zero-C form, C′ exactly symmetric, each direct call bit-identical on a
   second launch into NaN-filled memory (C′'s block and the partial-gram
   scratch's); float64 (≤ 1e-12) and float32
   (≤ 1e-4).  The flash attention kernel (row 9) at qwen2-0.5b's prefill
   (4, 2048, 14 heads, 2 KV heads, D=64), with windows 32 and 100 that
   start mid-tile, at a ragged S=129, at D=32 and D=128 and once
   non-causal, at the head dims 96, 112 and 256: phi3-mini's
   (1, 512, 32, 32, 96) and a ragged S = 333 with a window at each, and
   at every prefill shape of phases 14a-14e (``family_flash_shapes``):
   gemma3-4b's (4, 2048, 8, 4, 256) with its window of 1024 and without,
   moonshot's (4, 1024, 16, 16, 128), zamba2's shared block (4, 2048, 32,
   32, 112), musicgen's (4, 1024, 32, 32, 64) and llama-3.2-vision's (4,
   1024, 64, 8, 128), each flash check bit-identical on a second launch
   into NaN-filled memory;
   the WKV kernel (row 10) at rwkv6-3b's prefill (4, 1024, 40
   heads, D=64) with a non-zero initial state, final state compared too,
   and at D=32 and 128, each with and without the initial state again
   bit-identical on a second launch into NaN-filled memory; both in
   float32 (≤ 2e-5 of the largest |value|) and bfloat16 (element by
   element: |got − want| ≤ 2e-2·|want| + 1e-3 of the largest |value| of
   the element's row, its last axis; the phase's line gives each kernel's
   worst bf16 element as a share of its limit).  The backward kernels:
   flash attention's (row 11) at qwen2-0.5b's training shape (4, 1024,
   14, 2, 64), a ragged S = 129 with window 100, D = 32, D = 128, a
   non-causal call, a ragged S = 333 over several of the bf16 passes'
   128-row tiles with a query group of 3 and a window of 200 with a group
   of 5, each from the plain o and row statistic, after the forward's
   statistic (the training launch, whose o must equal the serving
   launch's bit for bit) is held against the plain one; the WKV's (row
   12) at rwkv6-3b's (4, 1024, 40, 64), D = 32 (two key-dim slices, once
   over 16 chunks) and 128, each with an initial state and a final-state
   gradient and without either;
   float32 within 1e-4 of each output's largest |value| (``LM_GRAD_TOL``),
   bf16 outputs element by element as the forward's but with each row's
   largest taken at least 1e-2 of the tensor's (``LM_GRAD_ROW_SHARE``:
   the first query's dq is zero in exact arithmetic), the f32 outputs of
   a bf16 call (dlogw, du, d state) as float32; each bit-identical on a
   second launch into NaN-filled memory, its scratch (row statistics and
   per-head partials; the chunks' states and pair terms) poisoned too.  At the campaign shapes
   (phases 9-9d stack their members on the slot axis): S = 16 members at
   (λ, n) = (12·2ᵏ, 40), k = 0…8, with the (1, 2) menu's real per-member
   coefficients (f1 and f2 × instances 1-4 × 2 runs, one member made
   invalid: modes, scales, shifts and f_opt rows mixed in one launch),
   rows 1-4 and 6; S = 48 and S = 6 (phase 10b's S2 islands) at the same
   widths, rows 1, 3 and 6; rows 2 and 6 at phase 10's S1 call (8, 12,
   1000) with the (1, 2) menu's coefficients; and rows 1
   and 6 at phase 9d's (24, 3072, 1000), whose update plan (chunks, scratch
   bytes) the line gives; each against its plain version and bit-identical
   on a second launch into NaN-filled memory, float64 and float32;
3. the main path at full size: ``run_ipop`` on BBOB f8 (n=1000, λ_max=3072,
   float64, 64 generations) through the sample and update kernels, with
   their launch counts and the time of one batched ``eigh`` at that width;
   plus the ladder at n=8 on the card and on the CPU's plain path (f8, and
   f1/f2 through the eval-fused kernel; both schedules), whose traces must
   agree;
3b. the same problem through ``run_ipop(backend="bucketed",
   impl="kernel_rng")`` for 12·64 evaluations: 64 generations on rung 0,
   padded to 12 rows instead of 3072, sampled by the in-kernel RNG tier
   (row 5's kernel, then the Z-operand sample kernel, one call a
   generation); its launches, segments, host pulls (segments + 1), padding
   and ms per generation beside phase 3's;
3c. the bucketed path at n=8, λ_start=16, 1 500 evaluations (cut from
   3 000 for the script's 1200 s when the service phases came) on the card
   and on the CPU (f8, and f1/f2 through the eval-fused kernels; ``auto``
   and ``kernel_rng``):
   every int leaf of the trace and the final carry exactly, every float
   leaf (best values, m, σ, C, the paths) element by element to 1e-9
   (``compare_small_runs``); and on the card bucketed against ladder, the
   ints of every executed generation exactly;
4. a whole IPOP run with restarts: ``run_ipop`` on f1 through the
   eval-fused sample kernel (n=40, λ_max=3072, 10 000 evaluations: cut
   from 100 000, then from 50 000 in PR 19, for the script's 1200 s;
   ``BUDGET``);
4b. the same run at 25 000 evaluations (``BUDGET_4B``; cut from 50 000
   when the service phases came) through
   ``backend="bucketed", impl="kernel_rng"`` (the eval kernel drawing its
   own Z), which must spend ``FEVALS_4B`` evaluations, then again with the speculative segment driver
   (``overlap=True``), whose result must be bit-identical;
4c. float32 campaigns: ``run_ipop(dtype="float32")`` on f1 (n=40, 10 000
   evaluations) on the card on both backends under ``auto`` and
   ``kernel_rng``, and the bucketed ``kernel_rng`` run on the CPU as well
   (``F32_CPU``; the ladder's ``auto`` run on the CPU too until the service
   phases needed the time): fevals,
   descents with their stop reasons and best − f_opt side by side.  Every
   run ends within its last population of the budget, on the rungs
   λ_start·2^k in order, with best − f_opt ≤ 8 float32 ulp of f_opt (the
   bound of ``tests/test_torch_float32.py``), and spends ``FEVALS_4C``
   evaluations; float32 descents may end at
   other generations on the two devices (their stop fires on ulp-level
   noise at the float32 floor), so those are shown, not compared; the
   float32 kernels must have run;
4d. the host-loop backend: ``run_ipop(backend="hostloop")`` on f1 through
   the eval-fused kernel (n=40, λ_max=3072, 10 000 evaluations), one host
   read a chunk: the budget spent but for less than the λ of the rung that
   could not start, f_opt + 1e-8 reached, a sample and an update launch a
   step;
9. ``campaign_bbob24_n40``: ``run_campaign_bucketed`` over the 24 fids ×
   instances (1, 2) (48 members, n=40, float64, λ_start=12, kmax_exp=8,
   ``impl="auto"``), under ``policy="cover"`` and then ``"min"``, 6 000
   evaluations a member (``"cover"`` cut from 10 000 for the script's
   1200 s when the service phases came): every member spends at most its
   budget, and more than the budget less the λ of the rung it ends on
   unless it retired on the last rung; at most 9 programs (``compiles``); exactly one sample
   launch (row 1) and one update launch (row 6) a step, whatever the
   member count; every f1 member at f_opt + 1e-8 (f2 members are
   reported, not held to a target); ms a step, wall seconds, padding waste
   and the ECDF per ``bbob.GROUPS`` entry over 51 targets 10²…10⁻⁸; then
   where a step's host time goes (``campaign_step_split``);
9b. ``campaign_sep_rng_n40``: the (1, 2) menu × instances 1-4 × 2 runs (16
   members) under ``impl="kernel_rng"``, 10 000 evaluations a member: row
   4, drawing Z in the kernel, with mixed per-member coefficients, and row
   6; the same checks;
9c. card against CPU at n=8: ``run_campaign`` and ``run_campaign_bucketed``
   over the menu (1, 2, 8) × instances (1, 2), λ_start=16, kmax_exp=2,
   1 500 evaluations a member, under ``auto`` and ``kernel_rng``: every int
   leaf of the traces and the evaluations exactly, the best values to 1e-9
   (``f_err``); then each of the 24 evaluators at n=40, one call on 64
   rows, card against CPU on the same instance, to 1e-12 (f16 and f19 1e-9,
   f17, f18 and f23 1e-11; f7 and f23 up to rows counted as
   rounding-boundary cases; ``EVAL_RTOL``);
9d. ``campaign_bbob24_n1000``: ``run_campaign`` (the λ_max-padded ladder,
   λ_max=3072) over the 24 fids × instance 1 at n=1000, float64, 16
   generations: rows 1 and 6 at (24, 3072, 1000), one launch each a
   generation; each member's evaluations the Σλ of its generations that
   ran, from the trace; ms a generation, the time of one batched ``eigh``
   of the 24 covariances and peak allocated memory (under 20 GB);
9e. no fallback: a small ladder (f1, n=8) on the card under
   ``impl="eager"`` and ``"eager_unfused"`` launches no kernel of
   ``kernels/csrc`` (none counted, none of their names in a
   ``torch.profiler`` trace); under ``"auto"`` it does, both ways;
10. ``mesh_n1000``: the mesh campaign engine (``run_campaign_mesh``) on
   8 islands of the card (S2's islands in turn): fids (1, 2) × instance
   1 × 4 runs at n = 1000, λ_start = 12, kmax_exp = 8, float64, 192
   evaluations a member (16 generations on rung 0, one segment;
   ``MESH``, cut for the script's time), under S1 (``"ordered"``, with
   and without the speculative segment) and S2 (``"concurrent"``), and
   ``run_campaign_bucketed`` on the same members: all give equal ints
   (evaluations, every int leaf of the trace) and best values within
   1e-9 (``f_err``); S1 one sample (row 2) and one update launch a step
   for all members, S2 one of each an island a step; ms a generation
   (S2's also an island's), peak allocated memory;
10b. ``mesh_campaign_n40``: phase 9's 48 members (24 fids × instances 1
   and 2, n = 40) on 8 islands, 2 000 evaluations a member (cut from
   3 000 when the service phases came)
   (``MESH_CAMPAIGN``), under S1 (without the speculative segment) and
   S2: budgets as phase 9 holds them, launches as phase 10; wall
   seconds, segments and exchange rounds, padded and useful evaluations,
   padding waste, the ECDF per BBOB group, and the padding S2 saves
   against S1;
10c. ``mesh_card_vs_cpu``: n = 8, fids (1, 2) × 4 runs on 4 islands, 200
   evaluations a member, both strategies under ``auto`` and
   ``kernel_rng``, card against CPU: ints equal, best values within 1e-9;
   ``run_ipop(backend="mesh")`` under both strategies on f1 (3 000
   evaluations, a restart) and f2 (1 000), card against CPU: evaluations
   and descents equal, bests within 1e-9, one sample and one update
   launch a step the engine launched; ``eager`` under S1 and
   ``eager_unfused`` under S2 (100 evaluations a member) launch no kernel
   on the card;
11. ``service_stream_n40``: the campaign service (``CampaignServer``,
   the 24-fid menu, λ_start = 12, kmax_exp = 8, 12 rows on one island of
   the card, segments of at most 16 generations, ``auto``, ``SERVICE``)
   serving a stream: 24 jobs at n = 40
   (fid j + 1, budgets 3 000-6 000 and priorities 0-2 from
   ``default_rng(0)``), 12 of them and f1 and f2 at n = 1000 (600
   evaluations) before the first boundary, the other 12 one a boundary
   after it; every job done within its budget, the n = 40 lane through
   at least two buckets (its jobs restart onto rung 1 and above), one
   sample (row 1) and one update launch an island step and no other
   kernel, at most 9 programs a lane and none added by a later job, one
   schedule pull a lane a boundary; every f1/f2 job equal to the
   bucketed engine of ``run_ipop(backend="bucketed")`` on its key and
   budget, run as one campaign a dim-class with per-member budgets
   (``bucketed_jobs``; ints, bests within 1e-9); wall, ms a boundary,
   jobs/s, evaluations/s, useful and padded evaluations and peak memory;
11b. ``service_snapshot_resume``: 6 jobs at n = 40 (fids 1, 2, 8, 10,
   15, 21; 2 000 evaluations, cut from 3 000) snapshotted at the middle
   boundary of the uninterrupted run, restored into a new server and
   drained: bit-identical to the uninterrupted run; the
   same snapshot restored onto 2 islands of the card: ints equal, bests
   within 1e-9;
11c. ``service_card_vs_cpu`` at n = 8 (λ_start = 16): f1, f2, f8 and a
   custom sphere (1 000 evaluations each; cut from 1 500 for the
   script's time), two admitted mid-flight, card against CPU (ints equal,
   bests within 1e-9, the sphere's, whose minimum is 0, on a floor of 1;
   row 1 and row 6 once an island step, the metrics
   JSONL schema-valid, the Chrome trace valid, one pull a boundary);
   ``run_ipop(backend="service")`` against ``backend="bucketed"`` on f1
   (3 000 evaluations, a restart): the same evaluations and descents, one
   sample and one update launch a launched step each; the (1, 2) menu
   alone (800 evaluations a job) on row 2 under ``auto`` (against
   ``eager``, which launches nothing) and row 4 under ``kernel_rng``
   (against the CPU);
12. ``fleet``, fleet supervision (``repro_torch.fleet``), each
   supervised run against the same run with ``fleet=None`` in this
   phase, its five parts at once in five workers: 12a
   ``run_ipop(backend="bucketed")`` on f1 at n = 40, 3 000 evaluations,
   snapshots every 2 boundaries, island 0 killed at boundary 3, under
   ``auto`` (row 2) and ``kernel_rng`` (row 4), under ``auto`` also a
   plan of a 10 ms delay at boundary 1 and a corrupt read at boundary 2
   (re-pulled, ``fleet_pull_retries_total`` ≥ 1): every result
   bit-identical; 12b the mesh engine on 2 islands of the card,
   S2 and S1, 1 000 evaluations in 16-generation segments, island 0
   killed at round 2: bit-identical; each supervised
   run launches the fault-free run's sample and update kernels plus one
   of each a replayed step (the segment records the recovery dropped,
   ``replayed_steps``), and exactly the plan's kills are graded dead;
   12c four jobs at n = 40 (f1 and f8 of the menu, a shifted sphere,
   2 000-2 500 evaluations) on a service of 2 islands of 4 rows, island 1
   killed at boundary 3 for 2 boundaries (rows reassigned, the island
   rejoins, the lane repacked), and of 2 rows (rows park until it
   rejoins), each part with its own fault-free server: every job's
   evaluations equal to the fault-free server's,
   bests within 1e-12, equal ``segment_compiles``, one sample (row 1)
   and one update launch an island step; the line gives each run's wall,
   replayed steps, recovery wall, lost-work evaluations and snapshot
   host ms a boundary; a ``fleet`` line gives the phase's span, from
   the first part's start to the last one's end;
13a. ``descent``: the dense single descent, ``cmaes.run`` (the JAX
   package's signature and key schedule), on f8 at n = 1000, default λ
   (24), 32 generations: one sample (row 1) and one update launch (row 6)
   a generation, λ evaluations each, ms a generation; then f1 at n = 8,
   λ = 16 (μ = n: distinct eigenvalues), card against CPU to its stop:
   ints equal, bests within 1e-9, the card's launches one of each a
   generation;
13b. ``train_qwen2``: ``Trainer.run`` on qwen2-0.5b at full width and
   all 24 layers (``attn_impl="flash"``, bf16 compute, f32 parameters
   and AdamW moments, remat off), 6 steps of 4 × 1024 tokens from
   ``SyntheticTokens``, lr 3e-3 with 2 warmup steps, a checkpoint every
   3 steps: every loss finite, the last two's mean below the first
   two's, flash forward and backward launches each 24 a step; then a run
   that stops after its step-3 checkpoint and its restart: the restored
   parameters and moments equal the stopped run's bit for bit, and the
   restart's losses at steps 4-6 (and the stopped run's at 1-3) within
   2e-3 of the uninterrupted run's, relative (``RESUME_TOL``); ms a step,
   tokens/s and peak memory;
13c. ``train_rwkv6``: ``Trainer.run`` on rwkv6-3b at full width
   (d_model 2560) cut to 4 of its 32 layers (all 32 with f32 AdamW hold
   about 50 GB beside five other workers), remat on, 4 steps of 4 × 1024
   tokens: losses finite, WKV backward launches 4 a step, forward 8 (each
   layer's forward again in its backward); ms a step, tokens/s, peak
   memory;
13d. ``train_card_vs_cpu``: both smoke configs, head dims widened to 32
   (the kernels' narrowest), float32, remat off, one ``grads_and_loss``
   and one ``make_train_step`` step of 4 × 64 tokens on the card and on
   the CPU from the same weights: the losses within 1e-5, every gradient
   leaf within 1e-4 of its largest |value| (``TRAIN_CPU_TOL``), forward
   and backward launches one each a layer a call;
14a-14e. the other LM families served at their published widths, random
   weights from seed 0, bf16 compute (``FAMILIES``): ``serve_gemma3_4b``
   (all 34 layers: 5 units of 5 sliding-window layers and a global one,
   and a 4-layer local tail; 4 prompts of 2048 tokens, past the 1024
   window, and 32 new tokens, which wrap the rings), ``serve_moonshot``
   (4 of 48 layers, 64 experts, top-6; 4 × 1024), ``serve_zamba2`` (13
   of 81 layers: 2 units of 6 Mamba2 layers and the shared block, and a
   tail layer; 4 × 2048), ``serve_musicgen`` (all 48 layers, 4 × 1024
   stub frames) and ``serve_llama_vision`` (one unit, 5 of 100 layers,
   bf16 weights; 4 × 1024 tokens and 1601 stub image embeddings); the
   first three through ``Engine.generate`` over the launcher's config
   after a warm-up (gemma3-4b, not cut in depth, first through the
   launcher itself at its default 4 × 16 prompts),
   the last two through ``lm.prefill`` and ``lm.decode_step`` (the
   launcher refuses their stub inputs, as the JAX package's does): prefill
   ms, decode ms a token, the phase's peak allocated memory (under 13b's
   25.53 GB, ``FAMILY_PEAK_GB``), exactly one flash launch a causal
   self-attention layer of a prefill (34, 4, 2, 48 and 4; the cross
   layers take the plain path) and no other kernel, gemma's counted by
   window (29 local, 5 global); the first decode step's logits against
   ``lm.forward``'s last logits over the prompt and that step's input,
   in bf16 and f32, within ``DECODE_TOL`` (MoE at capacity factor
   n_experts / top-k, where nothing drops; its bf16 figure printed);
14f. ``families_card_vs_cpu``: the eight configs of those families at
   their smoke cuts with head dims 32 (gemma at 14 layers, zamba2 at 10,
   so that tails exist), float32, 2 prompts of 50 tokens (past the smoke
   window of 32), the same weights on the card and on the CPU: prefill logits,
   every cache leaf and 6 teacher-forced decode steps' logits within
   1e-4 of their largest |value|, one flash launch a causal
   self-attention layer of the card's prefill and no other kernel;
6. the strategies path at full width: ``ladder.run_concurrent`` (the
   K-Distributed program) on BBOB f8, n=1000, 512 virtual devices of 12
   rows (nine descents, λ = 12…3072, 511 active), float64, ``impl="auto"``,
   16 generations: ms per generation, the grouped sample kernel's launches
   (one per generation), evaluations (exactly 6132 per generation), best −
   f_opt, peak allocated memory (under 4 GB) and the time of one batched
   ``eigh`` of the nine covariances;
6b. K-Distributed (7 devices, three descents, both ``comm`` schedules, 48
   generations) and K-Replicated (8 devices, 24 generations a phase) at
   n=8, λ_start=16, f1 and f2, on the card and on the CPU: every int leaf
   of trace and carry equal, every float leaf within 1e-9 (best values
   relative to |f| + |f − f_opt|, the others per descent relative to
   their largest entry);
6c. ``KReplicated.run_sim`` at n=1000, 8 devices, 8 generations of each
   phase, on the card: ms per generation per phase and the grouped sample
   kernel's launches;
7. the serving path at full width: first the launcher itself
   (``repro_torch.launch.serve.main``, default flags: 4 prompts of 16
   tokens), which must launch only its arch's kernel, once per layer; then
   ``Engine.generate`` over the launcher's config (``serve_config``) on
   qwen2-0.5b (24 layers, d_model 896, vocab 151 936, ``attn_impl="flash"``,
   bf16 compute over f32 weights from the port's init), 4 prompts of 2048
   tokens, 32 new tokens, after one warm-up call at the same shapes:
   prefill ms, decode ms per token and tokens/s, peak allocated
   memory, exactly 24 flash-attention launches (one prefill) and no other
   kernel; the first decode step's logits (position S) against
   ``lm.forward``'s last logits over the prompt plus the first new token
   (≤ 2e-2 of the largest |logit| in bfloat16, ≤ 1e-4 in float32);
7b. the same for rwkv6-3b (32 layers, d_model 2560), 4 prompts of 1024
   tokens: exactly 32 WKV launches, the check on the cached WKV state
   (≤ 5e-2 in bfloat16: 32 layers of two rounding orders, ≤ 1e-4 in
   float32);
7c. card against CPU: both archs at full width and 2 layers in float32,
   the same weights, 2 prompts of 50 tokens: prefill logits, every cache
   leaf and 8 teacher-forced decode steps' logits within 1e-4 of their
   largest |value|;
8. the neural-fitness path: ``run_ipop(make_nn_fitness(qwen2-0.5b at full
   width, SyntheticTokens B=4, S=512), n=26, λ_start=12, kmax_exp=1,
   max_evals=240, backend="bucketed")`` (cut from 480 when the service
   phases came): ms per
   evaluation, baseline CE
   (θ = 0) and best CE, evaluations, 24 flash launches per evaluated row;
   phases 7, 7b and 8 then profile one prefill, eight decode steps and
   four evaluations under ``torch.profiler`` (device busy time and share,
   aten calls, the kernels with the most device time);
5. the ``{"kernels": [...]}`` line: per kernel and per path (phases 3, 3b,
   4, 4b, 4c (float32, at (1, 3072, 40)), 4d, 6, 6b, 6c, 7, 7b, 7c, 8
   (row 1 at (1, widest, 26)), 9, 9b, 9c, 9d, 10, 10b, 10c, 11, 11b, 11c
   and 12; the campaign paths at (members, widest bucket, 40) and
   (24, 3072, 1000), the mesh paths at S1's call (8, 12, 1000) and (48,
   widest, 40) and S2's island (1, 12, 1000) and (6, widest, 40), the
   service at its n = 40 island (12, widest, 40) and 11c's (4, widest,
   8), phase 12's bucketed runs (``auto`` and ``kernel_rng``) and S2
   island at (1, widest, 40), its S1
   call at (2, widest, 40) and its service island at (4, widest, 40))
   its launches, its
   time, the plain version's time, one PyTorch call's time (none for the Z
   stream alone) and the least time the card could take (bound: the largest
   of the bytes over the memory's rate, the FP64 tensor-core operations,
   and for rows 3-5 the draw's INT32 operations and its FP64 instructions
   over their issue rates; a line before it gives each of these parts) at
   that path's shape (each time over 10 launches, or 200 where one takes
   under 0.2 ms; row 7: at every row layout of its paths; row 8, which no
   path launches: at phase 2's shapes); the top-level numbers are the
   phase-3 shape's for rows 1–6, phase 6's layout for row 7, (3072, 1000)
   for row 8 and the serving prefill's shapes for rows 9 and 10 (bound:
   bytes over 3.35 TB/s, or the unmasked work over 989 TFLOP/s for row 9's
   bf16 inputs and 67 for f32 and for row 10, which computes in f32
   whatever its inputs' type; one SDPA call is row 9's library time, row 10
   has none); row 9 also at each shape of phases 14a-14f (gemma3-4b's
   local layers with their window: the kept pairs bound it, and SDPA runs
   with an explicit boolean mask).  Rows 11 and 12 (the backward kernels, which replace no
   TPU kernel: ``replaces`` names their JAX counterparts) at the training
   paths' shapes, 13b's and 13c's in bf16 and 13d's in f32: bound the
   bytes (inputs once, gradients once) or the operations (row 11: 10·D a
   causal pair over 989 TFLOP/s for bf16 inputs, 67 for f32; row 12:
   B·H·S·(10·D² + 160·D) at the f32 FMA rate), the library time one
   autograd backward of SDPA (row 11, the median of 20 launches: the
   backend PyTorch picks with ``enable_gqa``, named, and the flash backend
   forced on K and V expanded to the query heads outside the timed call,
   the row's ``library_ms`` the faster; row 12 none).  Rows 8 and 10 also
   give ``tools/profile_update.py``'s
   ``profile_call`` over 20 calls beside the wall-clock ms: each kernel's
   device µs per launch and the launches ``torch.profiler`` recorded, the
   CUDA-event ms and the host µs of a call.  Rows 1-4 at the bucketed
   paths' shapes give the CUDA kernels a call launches (the kernels the
   profiler records over three windows of 20 calls):
   an RNG call as many as the Z-operand call of its shape where it draws Z
   in the kernel (n ≤ 64), one more (row 5's) on wider rows.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository's ``src/`` beside this file, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs, convert, obs  # noqa: E402
from repro_torch.core import (bucketed, cmaes, ipop, ladder,  # noqa: E402
                              prng, strategies)
from repro_torch.core.params import CMAConfig, make_params  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.distributed import mesh_engine, sharding  # noqa: E402
from repro_torch.fitness import bbob  # noqa: E402
from repro_torch.fitness.nn_fitness import make_nn_fitness  # noqa: E402
from repro_torch.fleet import (CORRUPT, DELAY, KILL, FaultEvent,  # noqa: E402
                               FaultPlan, FleetConfig)
from repro_torch.fleet.controller import (FleetController,  # noqa: E402
                                          IslandSupervisor)
from repro_torch.kernels import (_build, cma_gen, cma_sample,  # noqa: E402
                                 cma_update, flash_attention, ops, ref,
                                 rwkv6_wkv, sample_plan)
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.launch.mesh import make_campaign_mesh  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.service import server as service_server  # noqa: E402
from repro_torch.service.queue import CampaignRequest  # noqa: E402
from tools import profile_update  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): FP64 on the tensor cores and
# FP32 outside them; HBM3 bandwidth.
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float64: 1e-12, torch.float32: 1e-4}
LAM_START, KMAX = 12, 8                   # λ_max = 12·2⁸ = 3072
GENS = 64                                 # phase 3's generations
#: the evaluations of phase 4 (cut from 50 000 in PR 19: with 4b at
#: 50 000 and 3c at 6 000 the script took 1107 s of its 1200 on a slow
#: host; phase 4's ladder pads every rung to λ_max, so its kernels' shape
#: does not depend on the budget) and of phase 4b (whose widest bucket
#: phase 5 times rows 4 and 6 at; cut from 50 000 when the service phases
#: came, so its third descent, λ = 48, is cut short and λ = 96 is not
#: reached)
BUDGET, BUDGET_4B = 10_000, 25_000
MAIN = dict(S=1, lam=LAM_START << KMAX, n=1000)   # phase 3, f8
RESTARTS = dict(S=1, lam=LAM_START << KMAX, n=40)  # phase 4, f1 (eval kernel)
RAGGED = dict(S=3, lam=37, n=45)
#: a ragged shape of the sample kernels' stream plan: odd n above one
#: tile's width, so rows are not 16-byte aligned
RAGGED_STREAM = dict(S=2, lam=37, n=101)
#: the shapes the bucketed paths launch at: rung 0 of phase 3b, and every
#: bucket 12·2ᵏ of phase 4b below λ_max (which is RESTARTS)
BUCKETS = [(dict(MAIN, lam=LAM_START), None)] + [
    (dict(RESTARTS, lam=LAM_START << k), 1) for k in range(KMAX)]
#: the paths whose launches are counted: shape and the fid of the fitness.
#: The bucketed paths' shapes are those their kernels ran at (rung 0 of
#: phase 3b; the widest bucket phase 4b reached), filled in by main().
PATHS = {"main_path_f8": (MAIN, None), "ipop_f1_restarts": (RESTARTS, 1),
         "bucketed_rng_f8": (dict(MAIN, lam=LAM_START), None),
         "bucketed_rng_f1_restarts": (None, 1),
         "hostloop_f1": (RESTARTS, 1),
         "campaign_bbob24_n40": (None, None),
         "campaign_sep_rng_n40": (None, None),
         "campaign_bbob24_n1000": (dict(MAIN, S=24), None),
         "mesh_n1000_s1": (dict(MAIN, S=8, lam=LAM_START), 1),
         "mesh_n1000_s2": (dict(MAIN, lam=LAM_START), 1),
         "mesh_campaign_n40_s1": (None, None),
         "mesh_campaign_n40_s2": (None, None),
         "service_stream_n40": (None, None)}
_SAMPLE_CU = "src/repro_torch/kernels/csrc/cma_gen_sample.cu"
SOURCES = {
    "cma_gen_sample": (_SAMPLE_CU, "src/repro/kernels/cma_gen.py:91"),
    "cma_gen_sample_eval": (_SAMPLE_CU, "src/repro/kernels/cma_gen.py:322"),
    "cma_gen_update": ("src/repro_torch/kernels/csrc/cma_gen_update.cu",
                       "src/repro/kernels/cma_gen.py:447"),
    "cma_gen_sample_rng": (_SAMPLE_CU, "src/repro/kernels/cma_gen.py:311"),
    "cma_gen_sample_rng_eval": (_SAMPLE_CU,
                                "src/repro/kernels/cma_gen.py:337"),
    "cma_sample_z_rng": (_SAMPLE_CU, "src/repro/kernels/cma_gen.py:362"),
    "cma_sample": ("src/repro_torch/kernels/csrc/cma_sample.cu",
                   "src/repro/kernels/cma_sample.py:46"),
    "cma_rank_mu_update": ("src/repro_torch/kernels/csrc/cma_update.cu",
                           "src/repro/kernels/cma_update.py:53"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:93"),
    "wkv6_forward": ("src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
                     "src/repro/kernels/rwkv6_wkv.py:76"),
    # rows 11-12 replace no TPU kernel: their JAX counterparts are the
    # flash path's custom VJP and autodiff of the WKV chunk scan
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/models/flash_xla.py:143"),
    "wkv6_backward": ("src/repro_torch/kernels/csrc/rwkv6_wkv_bwd.cu",
                      "src/repro/models/rwkv6.py:109"),
}
#: the strategies paths: phase 6 (K-Distributed at full width), phase 6c
#: (K-Replicated at n=1000) and the small runs of phase 6b
STRAT = dict(n=1000, P=512, gens=16)
KREP = dict(n=1000, P=8, gens=8)
SMALL = dict(n=8, lam_start=16, lam_slots=16)
#: the (λ, n) at which phase 2 checks the rank-μ update kernel
RANK_MU_SHAPES = [(12, 1000), (3072, 1000), (192, 40)]
#: the LM kernels (rows 9-10): peaks per input dtype (dense BF16 on the
#: tensor cores, FP32 outside them), tolerances of phase 2 (float32:
#: relative to the largest |value|; bfloat16: element by element, with a
#: floor of LM_ROW_FLOOR of the row's largest |value|, ``lm_compare``), the
#: shapes phase 2 checks them at, and the serving and neural-fitness paths
#: of phases 7, 7b, 7c and 8
LM_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
LM_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
LM_ROW_FLOOR = 1e-3
FLASH_CHECKS = [dict(B=4, S=2048, H=14, Hk=2, D=64, window=0),
                dict(B=1, S=256, H=4, Hk=2, D=64, window=32),
                dict(B=1, S=256, H=4, Hk=2, D=64, window=100),
                # head dims 96, 112 and 256: phi3-mini, and a ragged S
                # with a window at each (phase 2 also checks every shape
                # of phases 14a-14e, ``family_flash_shapes``)
                dict(B=1, S=512, H=32, Hk=32, D=96, window=0),
                dict(B=2, S=333, H=8, Hk=4, D=256, window=100),
                dict(B=2, S=333, H=4, Hk=2, D=112, window=70),
                dict(B=2, S=333, H=6, Hk=2, D=96, window=200)]
#: the kernels line's path for phi3-mini's prefill shape, which phase 2
#: checks and no path runs: its launches are null
UNDRIVEN = "phase2_phi3_mini"
WKV_CHECK = dict(B=4, S=1024, H=40, D=64)
SERVE = {"qwen2-0.5b": dict(B=4, S=2048, new=32, kernel="flash_attention"),
         "rwkv6-3b": dict(B=4, S=1024, new=32, kernel="wkv6_forward")}
CARD_VS_CPU = dict(layers=2, B=2, S=50, steps=8, tol=1e-4)
#: a decode step's logits against a full forward's, relative to the largest
#: |logit|, at full depth, per arch: float32 is the tight check; in bfloat16
#: the two paths (flash or chunked-WKV prefill, SDPA or recurrent decode)
#: round differently in every layer, which over rwkv6-3b's 32 layers
#: measured 2.9e-2 on the card (qwen2-0.5b: 6.1e-3)
DECODE_TOL = {"qwen2-0.5b": {torch.bfloat16: 2e-2, torch.float32: 1e-4},
              "rwkv6-3b": {torch.bfloat16: 5e-2, torch.float32: 1e-4},
              # phases 14a-14e, rwkv6-3b's bounds: their first card
              # run measured bf16 2.0e-2 (gemma3-4b, 34 layers), 1.8e-2
              # (zamba2-7b), 1.4e-2 (musicgen-large), 9.1e-3
              # (llama-3.2-vision-90b) and float32 at most 5.9e-6
              "gemma3-4b": {torch.bfloat16: 5e-2, torch.float32: 1e-4},
              # MoE: compared at capacity_factor = n_experts / top-k, where
              # nothing drops; the bf16 figure is printed, not gated (None):
              # the two paths' bf16 activations differ by rounding, and a
              # near-tie between two experts can then route a token elsewhere
              # (first card run: 7.8e-3)
              "moonshot-v1-16b-a3b": {torch.bfloat16: None,
                                      torch.float32: 1e-4},
              "zamba2-7b": {torch.bfloat16: 5e-2, torch.float32: 1e-4},
              "musicgen-large": {torch.bfloat16: 5e-2, torch.float32: 1e-4},
              "llama-3.2-vision-90b": {torch.bfloat16: 5e-2,
                                       torch.float32: 1e-4}}
NN = dict(arch="qwen2-0.5b", B=4, S=512, lam_start=12, kmax_exp=1,
          max_evals=240)
#: the backward kernels (rows 11-12) in phase 2: float32 within
#: LM_GRAD_TOL of each output's largest |value| (the WKV's chunk
#: exponentials reach e^80, so a last-place change of a cumulative
#: log-decay moves an element by ~1e-5 of its size), bfloat16 outputs by
#: ``lm_compare``'s element rule, the f32 outputs of a bf16 call (dlogw,
#: du, d state) by the float32 bound; the shapes: qwen2-0.5b's training
#: shape, a ragged S with a window, D = 32 and 128, a non-causal call;
#: rwkv6-3b's training shape and D = 32 and 128, each with an initial
#: state and a final-state gradient and without either; the edges of the
#: bf16 tiling: a ragged S over several 128-row tiles with a query group of
#: 3, a window with a group of 5 (each pass-3 block takes one query head),
#: and D = 32's two key-dim slices over 16 chunks
LM_GRAD_TOL = 1e-4
#: a bf16 gradient's rows are held to their own largest |value| as the
#: forward's are, but to no less than LM_GRAD_ROW_SHARE of the tensor's:
#: a row whose gradient is zero in exact arithmetic (the first query's dq:
#: a softmax over one key is constant) holds only f32 rounding noise,
#: which the two versions round differently
LM_GRAD_ROW_SHARE = 1e-2
FLASH_BWD_CHECKS = [dict(B=4, S=1024, H=14, Hk=2, D=64, window=0, causal=True),
                    dict(B=2, S=129, H=4, Hk=2, D=64, window=100,
                         causal=True),
                    dict(B=1, S=256, H=4, Hk=4, D=32, window=0, causal=True),
                    dict(B=1, S=384, H=8, Hk=1, D=128, window=0, causal=True),
                    dict(B=1, S=256, H=4, Hk=2, D=64, window=0,
                         causal=False),
                    dict(B=2, S=333, H=6, Hk=2, D=64, window=0, causal=True),
                    dict(B=1, S=300, H=5, Hk=1, D=64, window=200,
                         causal=True)]
WKV_BWD_CHECKS = [dict(B=4, S=1024, H=40, D=64), dict(B=1, S=64, H=2, D=32),
                  dict(B=1, S=128, H=1, D=128), dict(B=2, S=256, H=3, D=32)]
#: phase 13a: the dense descent (``cmaes.run``) at n = 1000 on f8, default
#: λ, 32 generations; and card against CPU on f1 at n = 8 with λ = 16
#: (μ = 8 = n: with μ < n the first covariances have a repeated
#: eigenvalue, whose eigenvectors cuSOLVER and LAPACK pick differently)
DESCENT = dict(n=1000, gens=32, fid=8)
DESCENT_SMALL = dict(n=8, lam=16, fid=1, tol=1e-9)
#: phases 13b-13d: training.  qwen2-0.5b at full width and depth, bf16
#: compute over f32 parameters and moments, flash attention, remat off (so
#: each flash kernel launches once a layer a step), 6 steps of 4 × 1024
#: tokens, lr 3e-3 with 2 warmup steps, a checkpoint every 3 steps; the
#: resumed run's losses within RESUME_TOL of the uninterrupted run's,
#: relative (the embedding's backward sums with atomics on the card).
#: rwkv6-3b at full width (d_model 2560) cut to 4 of its 32 layers: all
#: 32 with f32 AdamW hold about 50 GB (3.1 B parameters × 16 bytes of
#: weights, gradients and two moments) beside five other workers on the
#: card; remat on (each WKV forward launches twice a layer a step), 4
#: steps.  Phase 13d: both smoke configs with their head dims widened to
#: 32 (the kernels' narrowest), float32, 4 × 64 tokens, one step on the
#: card and on the CPU from the same weights: the loss within 1e-5 and
#: every gradient leaf within TRAIN_CPU_TOL of its largest |value|.
TRAIN = dict(arch="qwen2-0.5b", B=4, S=1024, steps=6, ckpt_every=3,
             lr=3e-3, warmup=2)
TRAIN_RWKV = dict(arch="rwkv6-3b", B=4, S=1024, steps=4, layers=4,
                  lr=3e-3, warmup=2)
RESUME_TOL = 2e-3
TRAIN_CPU = dict(B=4, S=64, head_dim=32, loss_tol=1e-5)
TRAIN_CPU_TOL = 1e-4
#: phases 14a-14e: the LM families beside qwen2 and rwkv6, served at their
#: published widths (random weights from seed 0), cut in depth where the
#: weights would pass 13b's peak beside the other workers: gemma3-4b all
#: 34 layers (5 units and a 4-layer local tail; 2048-token prompts pass
#: the 1024 window, so the rings fill, and 32 new tokens wrap them),
#: moonshot 4 of 48 layers, zamba2 13 of 81 (2 units and a tail layer),
#: musicgen all 48, llama-3.2-vision one unit (5 of 100 layers) with bf16
#: weights; flash: the flash launches of a prefill (one per causal
#: self-attention layer);
#: ``engine``: through ``Engine.generate`` over the launcher's config, and
#: the launcher itself where the depth is not cut (the JAX package's
#: launcher refuses musicgen's and the vision model's stub inputs, so those
#: run ``lm.prefill`` and ``lm.decode_step``)
FAMILIES = {
    "gemma3-4b": dict(phase="14a_serve_gemma3_4b", tag="serve_gemma3_4b",
                      B=4, S=2048, new=32, layers=0, engine=True,
                      flash=34),
    "moonshot-v1-16b-a3b": dict(phase="14b_serve_moonshot",
                                tag="serve_moonshot", B=4, S=1024, new=32,
                                layers=4, engine=True, flash=4),
    "zamba2-7b": dict(phase="14c_serve_zamba2", tag="serve_zamba2", B=4,
                      S=2048, new=32, layers=13, engine=True, flash=2),
    "musicgen-large": dict(phase="14d_serve_musicgen", tag="serve_musicgen",
                           B=4, S=1024, new=32, layers=0, engine=False,
                           flash=48),
    "llama-3.2-vision-90b": dict(phase="14e_serve_llama_vision",
                                 tag="serve_llama_vision", B=4, S=1024,
                                 new=32, layers=5, engine=False, flash=4,
                                 param_dtype="bfloat16")}
#: 13b's peak allocated memory (PERF.md §5): no phase 14 may pass it
FAMILY_PEAK_GB = 25.53
#: phase 14f: the eight configs of those families at their smoke cuts with
#: head dims 32, float32, card against CPU (gemma at 14 layers and zamba2
#: at 10, so that tails exist; 50 prompt tokens pass the smoke window of 32)
FAMILIES_CPU = dict(archs=("gemma3-27b", "gemma3-4b", "phi3-mini-3.8b",
                           "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b",
                           "zamba2-7b", "musicgen-large",
                           "llama-3.2-vision-90b"),
                    layers={"gemma3-27b": 14, "gemma3-4b": 14,
                            "zamba2-7b": 10},
                    B=2, S=50, steps=6, head_dim=32, tol=1e-4)


def family_flash_shapes():
    """The flash shape of each prefill of phases 14a-14e, by its path in
    the kernels line (gemma3-4b's local and global layers apart): phase 2
    holds row 9 at each, the kernels line times each."""
    out = {}
    for arch, f in FAMILIES.items():
        cfg = configs.get_config(arch)
        c = dict(B=f["B"], S=f["S"], H=cfg.n_heads, Hk=cfg.n_kv_heads,
                 D=cfg.head_dim)
        if cfg.local_per_global:
            out[f"{f['tag']}_local"] = dict(c, window=cfg.sliding_window)
            out[f"{f['tag']}_global"] = dict(c, window=0)
        else:
            out[f["tag"]] = dict(c, window=cfg.sliding_window)
    return out

#: per source, the tensor-core instructions its SASS must hold: DMMA (FP64
#: tensor cores) for the float64 sample tiles (rows 1-4, 7) and the gram of
#: rows 6 and 8, HGMMA (wgmma) for row 9's bf16 products
TENSOR_SASS = {"cma_gen_sample": "DMMA", "cma_sample": "DMMA",
               "cma_gen_update": "DMMA", "cma_update": "DMMA",
               "flash_attention": "HGMMA", "flash_attention_bwd": "HGMMA"}
#: phase 4c: float32 campaigns on f1
F32 = dict(n=40, budget=10_000)
#: the (backend, impl) runs of phase 4c that the CPU repeats (the ladder's
#: ("ladder", "auto") too until the service phases needed its 34 s)
F32_CPU = (("bucketed", "kernel_rng"),)

#: INT32 operations per Z element of the counter stream (threefry.cuh), for
#: the bound: 20 rounds of an add, a rotate and an xor, five key injections
#: of two adds, the first key add, the counter's shift-or and each output
#: word's shift and or; the key schedule's constants are computed once a
#: thread, not per element
RNG_INT_OPS = 76
#: INT32 and FP64 (outside the tensor cores) lanes of an H100 SM, and its SMs
LANES_PER_SM, SMS = 64, 132
#: FP64 instructions per float64 Z element, counted by phase 1 from row 5's
#: SASS (``rng_fp64_ops``)
RNG_FP64_OPS = {}
#: phases 4b and 4c: the evaluations their runs spend (the RNG kernels keep
#: the stream's bits wherever Z is drawn, so the runs keep their
#: trajectories).  4b at 50 000 spent 49 908 over descents of 627, 452,
#: 367 and 145 generations at λ = 12, 24, 48, 96; at 25 000 the third
#: stops at the budget: 12·627 + 24·452 + 48·138
FEVALS_4B = 24_996
FEVALS_4C = 9_996
#: Z elements a thread of row 5's float64 kernel draws in its wide form
#: (16 bytes of columns of one row, ``cma_gen_sample.cu``)
RNG_ELEMENTS_PER_THREAD = 2
#: the campaigns (phases 9-9d): at n = 40, every fid × instances (1, 2)
#: with 6 000 evaluations a member under both policies (enough for every
#: f1 member to reach f_opt + 1e-8; "cover" ran 10 000 until the service
#: phases needed the time) (9), and the (1, 2) menu × instances
#: 1-4 × 2 runs at 10 000 (9b, and phase 2's per-member coefficients; the
#: counter stream's f1 members need more than 6 000); card against
#: CPU at n = 8 (9c); the λ_max-padded ladder over the 24 fids at n = 1000
#: for 16 generations, peak allocated memory under 20 GB (9d)
CAMPAIGN = dict(n=40, instances=(1, 2), budget=10_000,
                budgets={"cover": 6_000, "min": 6_000})
CAMPAIGN_SEP = dict(fids=(1, 2), instances=(1, 2, 3, 4), runs=2)
#: the generations of phase 9's step split (``campaign_step_split``):
#: each unprofiled window's, and the profiled window's (whose trace of some
#: 7 000 aten calls a step takes seconds a generation to read back)
SPLIT_GENS, SPLIT_PROFILED_GENS = 12, 4
CAMPAIGN_SEP_SLOTS = 16
CAMPAIGN_SMALL = dict(fids=(1, 2, 8), instances=(1, 2), n=8, lam_start=16,
                      kmax_exp=2, max_evals=1500)
CAMPAIGN_WIDE = dict(members=24, gens=16, peak_gb=20.0)
#: phase 2's member counts at the campaign widths (12·2ᵏ, 40): phase 9b's,
#: phase 9's (and 10b's S1) and 10b's S2 islands'
CAMPAIGN_SLOTS = (CAMPAIGN_SEP_SLOTS, 48, 6)
#: the ECDF's 51 targets, 10^2 … 10^-8
ECDF_TARGETS = 10.0 ** np.linspace(2, -8, 51)
#: phase 9c's evaluators, card against CPU: relative tolerance per fid
#: (1e-12 elsewhere), as tests/test_torch_bbob.py holds the port to JAX,
#: and f23 at 1e-11: its 32 scales 2ʲ·z and 40 factors (1 + i·Σ)^0.119
#: carry a last-ulp difference of z (cuBLAS's and the CPU's X·Rᵀ sum in
#: other orders) to 2.6e-12 and 3.5e-12 (two runs on an H100 80GB HBM3
#: at 700 W) on rows far from any rounding boundary
EVAL_RTOL = {16: 1e-9, 19: 1e-9, 17: 1e-11, 18: 1e-11, 23: 1e-11}
#: phase 4d: the host-loop backend on f1
HOSTLOOP = dict(n=40, budget=10_000)
#: phases 10-10c, the mesh campaign engine on islands of the one card:
#: 10 fids (1, 2) × instance 1 × 4 runs at n = 1000 on 8 islands, 192
#: evaluations a member (16 generations on rung 0, so one segment; cut
#: from 1 728 for the script's 1200 s: at n = 1000 a member climbs no rung
#: within a budget the script can pay); 10b phase 9's 48 members at n = 40
#: on 8 islands, 2 000 evaluations a member (3 000 until the service
#: phases came; there S2 padded 17.5 % less than S1, at 2 000 3.5 %),
#: where members climb at different
#: times, so S2 pads less than S1, S1 without
#: the speculative segment (phase 10 times it both ways; the padding counts
#: accepted segments only); 10c n = 8, fids (1, 2) × 4 runs on 4 islands,
#: 200 evaluations a member, card against CPU, and each plain tier once
#: at 100
MESH = dict(islands=8, fids=(1, 2), runs=4, budget=192)
MESH_CAMPAIGN = dict(islands=8, budget=2000)
MESH_SMALL = dict(islands=4, fids=(1, 2), runs=4, n=8, lam_start=16,
                  kmax_exp=2, max_evals=200)
MESH_PLAIN_BUDGET = 100
#: phase 10c's ``run_ipop(backend="mesh")`` at n = 8 on one island: each
#: fid's evaluations, f1's enough for a restart (its first descent stops
#: after 2 672), f2's for one descent
MESH_IPOP = dict(budgets={1: 3000, 2: 1000}, n=8, lam_start=16,
                 kmax_exp=2)
#: phases 11-11c, the campaign service on one island of the card (12 rows,
#: the 24-fid menu): 11 24 jobs at n = 40 (budgets 3 000-6 000 from
#: ``default_rng(0)``) and f1/f2 at n = 1000
#: (600 evaluations, 50 generations at λ = 12); 11b 6 jobs at n = 40 with
#: a snapshot at the middle boundary; 11c n = 8 (λ_start = 16 = 2n, as
#: 3c), card against CPU, 1 000 evaluations a job, the (1, 2)-menu servers
#: 800.  11 and 11b cut segments at 16 generations (``seg_blocks``; the
#: default 64 under "cover"): a late job waits at most 16 steps for a
#: boundary, and an island with one live job stops paying 64-step
#: segments of padding (1 216 island steps for 110 568 evaluations at 64,
#: a run on an H100 80GB HBM3 at 700.00 W)
SERVICE = dict(n=40, wide_n=1000, lam_start=LAM_START, kmax_exp=KMAX,
               max_budget=6000, rows=12, budgets=(3000, 6000),
               wide_budget=600, seg_blocks=16)
SERVICE_SNAPSHOT = dict(fids=(1, 2, 8, 10, 15, 21), budget=2000)
SERVICE_SMALL = dict(n=8, lam_start=16, kmax_exp=2, budget=1000,
                     sep_budget=800, ipop_budget=3000)
#: phase 12, fleet supervision on the card: f1 at n = 40 with 3 000
#: evaluations on the bucketed driver (12a: 4 segments of 64 steps; under
#: ``auto`` a run with a corrupt read and a delay besides the kill's) and
#: 1 000 on 2 islands of the mesh engine (12b: segments of 16
#: generations), snapshots every 2 boundaries, island 0 killed at
#: boundary 3 (12a) and round 2 (12b); 12c a service of 2 islands with 4
#: rows (2 in its parking run), 16-generation segments, 4 jobs at n = 40,
#: island 1 killed at boundary 3 for 2 boundaries.  Cut for the script's
#: 1200 s: at 3 000 evaluations and 64-generation segments in 12b and a
#: job of 3 000 in 12c the phase took 119.5 s of a 1038 s serial run
#: (H100 80GB HBM3, 700.00 W)
FLEET = dict(n=40, budget=3000, mesh_budget=1000, mesh_seg_blocks=16,
             lam_start=LAM_START, kmax_exp=KMAX, snapshot_every=2, kill=3,
             mesh_islands=2, mesh_kill=2)
FLEET_SERVICE = dict(n=40, islands=2, rows=4, small_rows=2, kill=(1, 3, 2),
                     lam_start=LAM_START, kmax_exp=KMAX, seg_blocks=16)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs, made from a seed with numpy
# ---------------------------------------------------------------------------

def sample_inputs(S, lam, n, dtype, dev, seed=0, fid=None):
    """Sample-kernel operands and separable coefficients in the kernel's
    per-slot layout: those of BBOB ``fid`` (instance 1, as phase 4 runs
    it), or else random ones mixing both modes and an invalid slot."""
    rng = np.random.default_rng(seed)
    B = torch.linalg.qr(torch.tensor(rng.normal(size=(S, n, n)),
                                     device=dev))[0].contiguous()

    def t(a):
        return torch.tensor(a, device=dev)
    args = dict(m=t(rng.normal(size=(S, n))),
                sigma=t(rng.uniform(0.1, 0.5, size=S)), B=B,
                D=t(rng.uniform(0.5, 2.0, size=(S, n))),
                Z=t(rng.normal(size=(S, lam, n))))
    if fid is not None:
        sep = bbob.separable_coeffs(bbob.make_instance(fid, n, 1, device=dev),
                                    (fid,))
    else:
        sep = bbob.SepCoeffs(
            scale=t(np.power(10.0, 6.0 * np.arange(n) / max(n - 1.0, 1.0))
                    ).expand(S, n),
            shift=t(rng.uniform(-4.0, 4.0, size=(S, n))),
            f_opt=t(np.round(rng.uniform(-100, 100, size=S), 2)),
            mode=torch.tensor([1 - s % 2 for s in range(S)],
                              dtype=torch.int32, device=dev),
            valid=torch.tensor([s != 2 for s in range(S)], device=dev))
    # an instance's coefficients repeat over the S slots; the random ones
    # are S members of one slot each
    return ({k: v.to(dtype).contiguous() for k, v in args.items()},
            ops.slot_sep(sep, S if fid is not None else 1, dtype))


def kernel_eval(a, sep):
    return cma_gen.gen_sample_eval(*a.values(), *sep)


def seed_words(S, dev, seed=0):
    """(S, 2) uint32 seed words held in int64, the first one ≥ 2³¹."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2 ** 32, size=(S, 2), dtype=np.uint64).astype(
        np.int64)
    w[0, 0] |= 2 ** 31
    return torch.tensor(w, device=dev)


def rng_args(a):
    """The RNG kernels' operands from ``sample_inputs``' (Z is not used)."""
    return {k: a[k] for k in ("m", "sigma", "B", "D")}


def update_inputs(S, lam, n, dtype, dev, seed=1, zero_slot=True):
    """State, population and rank weights as the ladder hands them over:
    slot 0 at full rung, slot 1 at a smaller rung, the last slot (ragged
    case) with all-zero weights."""
    rng = np.random.default_rng(seed)
    s_in, _ = sample_inputs(S, lam, n, torch.float64, dev, seed)
    B, D = s_in["B"], s_in["D"]
    C = ref.mirror_upper(B @ (D[..., None] ** 2 * B.transpose(-1, -2)))
    cfg = CMAConfig(n=n, lam=lam)
    w = np.zeros((S, lam))
    coef = np.zeros((S, len(cma_gen.COEF_FIELDS)))
    for s in range(S):
        p = make_params(cfg, lam=max(2, lam >> s))
        if not (zero_slot and s == S - 1 and S > 1):
            w[s] = rng.permutation(p.weights.numpy())
        coef[s] = [float(getattr(p, f)) for f in cma_gen.COEF_FIELDS[:-1]] \
            + [float(3 + s)]

    def t(a):
        return torch.tensor(a, device=dev).to(dtype).contiguous()
    return dict(C=t(C.cpu().numpy()), B=t(B.cpu().numpy()),
                D=t(D.cpu().numpy()),
                p_sigma=t(0.3 * rng.normal(size=(S, n))),
                p_c=t(0.3 * rng.normal(size=(S, n))),
                Y=t(rng.normal(size=(S, lam, n))), w=t(w), coef=t(coef))


def ref_update(a):
    return ref.fused_gen_update(a["C"], a["B"], a["D"], a["p_sigma"],
                                a["p_c"], a["Y"], a["w"],
                                *a["coef"].unbind(1))


def strategy_layouts(dev):
    """(label, row starts, n) of every row layout a strategies path gives
    the grouped sample kernel: phase 6's heap, one descent of each λ,
    phase 6c's K-Replicated groups, phase 6b's small runs."""
    def rows(starts, lam):
        return tuple(s * lam for s in starts)
    kd = strategies.KDistributed(n=STRAT["n"], n_devices=STRAT["P"],
                                 lam_start=LAM_START, lam_slots=LAM_START,
                                 device=dev)
    small = strategies.KDistributed(n=SMALL["n"], n_devices=7, device=dev,
                                    **{k: SMALL[k] for k in ("lam_start",
                                                             "lam_slots")})
    out = [("kdist_f8", rows(kd.groups.starts, LAM_START), STRAT["n"])]
    out += [(f"descent_lam{LAM_START << k}", (0, LAM_START << k), STRAT["n"])
            for k in range(KMAX + 1)]
    def krep(label, P, lam, n):
        """Phase k's groups of 2ᵏ devices, k = 0…log2 P."""
        return [(f"{label}_G{P >> k}",
                 tuple(range(0, P * lam + 1, lam << k)), n)
                for k in range(P.bit_length())]
    out += krep("krep_n1000", KREP["P"], LAM_START, KREP["n"])
    out += [("kdist_small", rows(small.groups.starts, SMALL["lam_start"]),
             SMALL["n"])]
    out += krep("krep_small", 8, SMALL["lam_start"], SMALL["n"])
    return out


def grouped_inputs(starts, n, dtype, dev, seed=0):
    """The grouped sample kernel's operands: one state per group (B from a
    QR, D, m, σ) and a Z row for every row of ``starts``."""
    G, R = len(starts) - 1, starts[-1]
    rng = np.random.default_rng(seed)
    B = torch.linalg.qr(torch.tensor(rng.normal(size=(G, n, n)),
                                     device=dev))[0]

    def t(a):
        return torch.as_tensor(a, device=dev).to(dtype).contiguous()
    return dict(B=t(B), D=t(rng.uniform(0.5, 2.0, size=(G, n))),
                Z=t(rng.normal(size=(R, n))), m=t(rng.normal(size=(G, n))),
                sigma=t(rng.uniform(0.1, 0.5, size=G)))


def rank_mu_inputs(lam, n, dtype, dev, seed=2, S=1, negative=False):
    """The rank-μ update kernel's operands at (λ, n): C, Y, w (half the
    rows weighted, in permuted order), p_c and (decay, c_μ, c₁) per slot.
    With ``S`` = 2 the second slot's weights are all zero; with
    ``negative`` every other weighted row's weight changes sign."""
    u = update_inputs(S, lam, n, dtype, dev, seed, zero_slot=S > 1)
    w = u["w"]
    if negative:
        w = w.clone()
        w[:, 1::2] = -w[:, 1::2]
    coef = torch.tensor([[0.7, 0.2, 0.05]] * S, device=dev).to(dtype)
    return dict(C=u["C"], Y=u["Y"], w=w, p_c=u["p_c"], coef=coef)


# ---------------------------------------------------------------------------
# comparisons and timing
# ---------------------------------------------------------------------------

def compare(name, got, want, dtype, tol=None):
    """Max abs and max relative (to the largest |want|) error, at most
    ``tol`` (default ``TOL[dtype]``); NaNs must sit in the same places."""
    tol = TOL[dtype] if tol is None else tol
    worst_abs, worst_rel = 0.0, 0.0
    for g, w in zip(got, want):
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"{name}: NaN pattern differs")
        ok = ~torch.isnan(w)
        diff = float((g[ok] - w[ok]).abs().max()) if ok.any() else 0.0
        scale = float(w[ok].abs().max()) if ok.any() else 1.0
        worst_abs = max(worst_abs, diff)
        worst_rel = max(worst_rel, diff / max(scale, 1e-300))
    if not worst_rel <= tol:
        raise AssertionError(f"{name} ({dtype}): max relative error "
                             f"{worst_rel:.3e} > {tol:.0e}")
    return worst_abs, worst_rel


def lm_compare(name, got, want, dtype, tensor_share=0.0):
    """Rows 9-12 against their plain versions: (max abs error, max error
    over the largest |want|, worst element ratio).  float32: within
    ``LM_TOL`` of the largest |want| (``compare``; no ratio).  bfloat16:
    every element within ``LM_TOL·|want| + LM_ROW_FLOOR · (largest |want|
    of its row)``, rows being the last axis, a row's largest taken at
    least ``tensor_share`` of the tensor's largest |want|; the ratio is the
    largest |got − want| over that limit, at most 1."""
    got, want = [g.float() for g in got], [w.float() for w in want]
    if dtype == torch.float32:
        return (*compare(name, got, want, dtype, LM_TOL[dtype]), None)
    worst = 0.0
    for g, w in zip(got, want):
        row = torch.clamp(w.abs().amax(dim=-1, keepdim=True),
                          min=tensor_share * float(w.abs().max()))
        lim = LM_TOL[dtype] * w.abs() + LM_ROW_FLOOR * row
        worst = max(worst, float(((g - w).abs() / lim.clamp_min(1e-30))
                                 .max()))
    if not worst <= 1.0:
        raise AssertionError(f"{name} ({dtype}): an element misses "
                             f"{LM_TOL[dtype]:.0e}·|want| + {LM_ROW_FLOOR:.0e}"
                             f"·row max by a factor {worst:.3e}")
    return (*compare(name, got, want, dtype, float("inf")), worst)


#: the integer type of each float type's bits
BITS = {torch.float64: torch.int64, torch.float32: torch.int32,
        torch.bfloat16: torch.int16}


def same_bits(name, got, want):
    """Every output bit for bit (a NaN equals a NaN of the same bits)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if not (g.dtype == w.dtype and g.shape == w.shape
                and torch.equal(g.view(BITS[g.dtype]), w.view(BITS[w.dtype]))):
            differ = ~((g == w) | (torch.isnan(g) & torch.isnan(w)))
            raise AssertionError(
                f"{name}: output {i} not bit-identical: {int(differ.sum())} "
                f"of {g.numel()} elements differ, {int(torch.isnan(g).sum())}"
                f" NaN against {int(torch.isnan(w).sum())}")


def poisoned_update(u):
    """``cma_gen.gen_update(**u)`` just after blocks of the sizes it
    allocates (C′, the three vectors, the scratch), in its order, were
    filled with NaN and freed: the caching allocator most likely hands
    them back to it, so an output or scratch element that the kernels read
    or return without writing it shows as a NaN or a changed bit, not as
    an earlier launch's leftovers."""
    C, Y = u["C"], u["Y"]
    S, lam, n = Y.shape
    sizes = (C.numel(), 3 * S * n,
             sum(cma_gen.update_plan(S, lam, n).scratch().values()))
    poison = [torch.full((k,), float("nan"), dtype=C.dtype, device=C.device)
              for k in sizes]
    del poison
    return cma_gen.gen_update(**u)


def repeat_on_poison(name, call, first, scratch=0):
    """``call()`` again just after blocks of the sizes of the storages
    behind ``first`` (the first call's outputs, still held) and then one of
    ``scratch`` elements (the scratch the call allocates after its
    outputs) were filled with NaN and freed, as ``poisoned_update`` does:
    an output element the kernels leave unwritten, or a scratch element
    read before it is written, shows as a NaN or a changed bit.  Its bits
    must equal ``first``'s."""
    sizes = {}
    for t in first:
        st = t.untyped_storage()
        sizes[st.data_ptr()] = (st.nbytes() // t.element_size(), t.dtype)
    blocks = list(sizes.values()) + ([(scratch, first[0].dtype)]
                                     if scratch else [])
    poison = [torch.full((k,), float("nan"), dtype=dt, device=first[0].device)
              for k, dt in blocks]
    del poison
    same_bits(f"{name} (second launch on NaN)", call(), first)


def symmetric(name, C):
    """C equals its transpose bit for bit."""
    if not torch.equal(C, C.transpose(-1, -2)):
        raise AssertionError(f"{name}: C' is not symmetric")


def same_result(name, got, want):
    """Two IPOPResults, bit for bit: every descent's record, the best value
    and point, the evaluations and the driver's bucket sequence."""
    if not (got.total_fevals == want.total_fevals
            and got.best_f == want.best_f
            and np.array_equal(got.best_x, want.best_x)
            and len(got.descents) == len(want.descents)
            and all(a.k_exp == b.k_exp and a.stop_reason == b.stop_reason
                    and all(np.array_equal(x, y) for x, y in
                            zip(a[2:5], b[2:5]))
                    for a, b in zip(got.descents, want.descents))
            and [sg["bucket"] for sg in got.driver["segments"]]
            == [sg["bucket"] for sg in want.driver["segments"]]):
        raise AssertionError(f"{name}: result not bit-identical")


def time_ms(fn, reps=10, short_reps=200, short_ms=0.2) -> float:
    """Mean ms of a launch over ``reps`` launches after a warm-up, or over
    ``short_reps`` where one takes under ``short_ms`` (ten such launches
    moved by up to 55 % between calls)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run(k):
        start.record()
        for _ in range(k):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / k
    ms = run(reps)
    return run(short_reps) if ms < short_ms else ms


@functools.lru_cache(maxsize=1)
def sm_clock_hz() -> float:
    """The card's top SM clock (``nvidia-smi``'s ``clocks.max.sm``)."""
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def bound_parts(flops, nbytes, dtype, draws=0):
    """The least ms of each resource a kernel's work needs: ``bytes`` over
    the memory's rate, ``operations`` (the GEMM's) over the peak of
    ``dtype``, and for ``draws`` Z elements of the counter stream its
    ``int32`` operations and ``fp64`` instructions, each over the SMs'
    lanes at the top SM clock."""
    parts = {"bytes": nbytes / PEAK_BYTES * 1e3,
             "operations": flops / PEAK_FLOPS[dtype] * 1e3}
    if draws:
        rate = LANES_PER_SM * SMS * sm_clock_hz()
        parts["int32"] = draws * RNG_INT_OPS / rate * 1e3
        parts["fp64"] = draws * RNG_FP64_OPS["f64"] / rate * 1e3
    return parts


def issue_floor_ms(draws):
    """The least ms of ``draws`` Z elements of row 5's kernel by its issued
    instructions alone: 4 warp instructions a clock an SM (128 lanes) at
    the top SM clock."""
    return draws * RNG_FP64_OPS["issued"] / (
        4 * 32 * SMS * sm_clock_hz()) * 1e3


def bound(flops, nbytes, dtype, draws=0):
    """(least ms, what binds: ``bytes`` or ``operations``)."""
    parts = bound_parts(flops, nbytes, dtype, draws)
    by = max(parts, key=parts.get)
    return parts[by], "bytes" if by == "bytes" else "operations"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(dev):
    setup()
    libs = _build.build_all()
    ptxas = []
    for name in _build.SOURCES:
        log = libs[name].parent / f"{name}.ptxas.log"
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    RNG_FP64_OPS.update(rng_fp64_ops(libs["cma_gen_sample"]))
    emit({"phase": "build", "gpu": gpu_line(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": _build.build_seconds, "ptxas": ptxas,
          "tensor_sass": tensor_sass(libs),
          "rng_fp64_ops_per_element": RNG_FP64_OPS,
          "sm_clock_mhz": sm_clock_hz() / 1e6})


def sass_functions(lib):
    """Per kernel of a built library, its SASS lines (``cuobjdump``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        funcs[name.strip()] = body
    return funcs


#: a SASS instruction line: its address, then the instruction
SASS_LINE = re.compile(r"/\*[0-9a-f]{4}\*/\s+([^;]*);")
#: the FP64 arithmetic instructions of a draw (FMA, add, multiply)
FP64_OPS = ("DFMA", "DADD", "DMUL")


def rng_fp64_ops(lib):
    """Per float64 Z element of row 5's wide (16-byte) kernel, the FP64
    arithmetic instructions (``f64``) and all the instructions
    (``issued``) of its main body: its SASS up to the first EXIT that no
    predicate guards, past which lie the out-of-line slow paths the body
    calls under guards (cos's reduction of large arguments among them:
    2π·u2 < 2π never takes it), over the elements a thread draws there.
    The body's rare inline branches are counted too."""
    funcs = sass_functions(lib)
    name = next(k for k in funcs if "z_rng_kernelIdLb1E" in k)
    main = []
    for line in funcs[name].splitlines():
        m = SASS_LINE.search(line)
        if not m:
            continue
        ins = m.group(1).split()
        main.append(ins[1] if ins[0].startswith("@") else ins[0])
        if ins[0] == "EXIT":
            break
    ops = sum(op.split(".")[0] in FP64_OPS for op in main)
    return {"f64": ops / RNG_ELEMENTS_PER_THREAD,
            "issued": len(main) / RNG_ELEMENTS_PER_THREAD}


def tensor_sass(libs):
    """Per source of ``TENSOR_SASS``, how many of its tensor-core
    instructions ``cuobjdump -sass`` finds in the built library; none
    fails."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    found = {}
    for name, op in TENSOR_SASS.items():
        sass = subprocess.run([tool, "-sass", str(libs[name])],
                              capture_output=True, text=True,
                              check=True).stdout
        found[name] = {op: len(re.findall(rf"\b{op}\b", sass))}
        if not found[name][op]:
            raise AssertionError(f"{name}: no {op} instruction in its SASS")
    return found


def phase_kernels(dev):
    """Every kernel against its plain version; returns the max errors."""
    errs = {k: 0.0 for k in SOURCES}
    rows = []
    shapes = ([(MAIN, None), (RESTARTS, 1), (RAGGED, None),
               (RAGGED_STREAM, None)] + BUCKETS)
    for shape, fid in shapes:
        for dtype in (torch.float64, torch.float32):
            S, lam, n = shape["S"], shape["lam"], shape["n"]
            a, sep = sample_inputs(S, lam, n, dtype, dev, fid=fid)
            seeds = seed_words(S, dev, seed=lam + n)
            r = rng_args(a)
            errs_here = {}
            got = cma_gen.gen_sample(**a)
            want = ref.gen_sample(**a)
            errs_here["cma_gen_sample"] = compare("cma_gen_sample", got, want,
                                                  dtype)
            repeat_on_poison("cma_gen_sample", lambda: cma_gen.gen_sample(**a),
                             got)
            got = kernel_eval(a, sep)
            want = ref.gen_sample_eval(**a, sep=sep)
            errs_here["cma_gen_sample_eval"] = compare(
                "cma_gen_sample_eval", got, want, dtype)
            repeat_on_poison("cma_gen_sample_eval",
                             lambda: kernel_eval(a, sep), got)
            u = update_inputs(S, lam, n, dtype, dev)
            got = poisoned_update(u)
            want = ref_update(u)
            errs_here["cma_gen_update"] = compare("cma_gen_update", got,
                                                  want, dtype)
            symmetric("cma_gen_update", got[0])
            # the chunks' partials are summed in a fixed order: a second
            # launch on the same inputs gives the same bits
            same_bits("cma_gen_update (second launch)", got,
                      poisoned_update(u))
            got = cma_gen.gen_sample_rng(**r, seeds=seeds, lam=lam)
            want = ref.gen_sample_rng(**r, seeds=seeds, lam=lam)
            errs_here["cma_gen_sample_rng"] = compare(
                "cma_gen_sample_rng", got, want, dtype)
            repeat_on_poison("cma_gen_sample_rng", lambda: cma_gen.gen_sample_rng(
                **r, seeds=seeds, lam=lam), got)
            got = cma_gen.gen_sample_rng_eval(*r.values(), seeds, lam, *sep)
            want = ref.gen_sample_rng_eval(*r.values(), seeds, lam, sep)
            errs_here["cma_gen_sample_rng_eval"] = compare(
                "cma_gen_sample_rng_eval", got, want, dtype)
            repeat_on_poison(
                "cma_gen_sample_rng_eval", lambda: cma_gen.gen_sample_rng_eval(
                    *r.values(), seeds, lam, *sep), got)
            got = cma_gen.sample_z_rng(seeds, lam, n, dtype)
            want = ref.sample_z_rng(seeds, lam, n, dtype)
            errs_here["cma_sample_z_rng"] = compare(
                "cma_sample_z_rng", (got,), (want,), dtype)
            repeat_on_poison("cma_sample_z_rng", lambda: (
                cma_gen.sample_z_rng(seeds, lam, n, dtype),), (got,))
            drawn_as_loaded(a, sep, seeds, got)
            torch.cuda.synchronize()
            for k, e in errs_here.items():
                if dtype == torch.float64:
                    errs[k] = max(errs[k], e[0])
                rows.append({"kernel": k, "shape": [S, lam, n],
                             "dtype": str(dtype), "max_abs_err": e[0],
                             "max_rel_err": e[1],
                             "repeat_bit_identical": True})
    campaign_rows, wide_plan = campaign_kernel_checks(dev, errs)
    rows += campaign_rows
    rows += strategy_kernel_checks(dev, errs)
    rows += lm_kernel_checks(dev, errs)
    rows += lm_grad_checks(dev, errs)
    bf16_worst = {name: max(r["max_elem_ratio"] for r in rows
                            if r["kernel"] == name
                            and r["dtype"] == str(torch.bfloat16))
                  for name in ("flash_attention", "wkv6_forward",
                               "flash_attention_bwd", "wkv6_backward")}
    emit({"phase": "kernels_vs_plain", "checks": rows,
          "update_plan_campaign_n1000": wide_plan,
          "bf16_worst_share_of_limit": bf16_worst,
          "rng_prefix_stable": rng_prefix_checks(dev)})
    return errs


def drawn_as_loaded(a, sep, seeds, Z):
    """Rows 3-4 against rows 1-2 on row 5's Z of the same seeds, bit for
    bit; an RNG call that draws Z in the kernel allocates no Z scratch."""
    S, lam, n = Z.shape
    r = rng_args(a)

    def rng_call(name, call):
        return (no_scratch(name, call, Z) if sample_plan.draws_z(n)
                else call())
    same_bits("cma_gen_sample_rng against cma_gen_sample on row 5's Z",
              rng_call("cma_gen_sample_rng",
                       lambda: cma_gen.gen_sample_rng(*r.values(), seeds,
                                                      lam)),
              cma_gen.gen_sample(**r, Z=Z))
    same_bits("cma_gen_sample_rng_eval against cma_gen_sample_eval on row "
              "5's Z", rng_call(
                  "cma_gen_sample_rng_eval",
                  lambda: cma_gen.gen_sample_rng_eval(*r.values(), seeds,
                                                      lam, *sep)),
              cma_gen.gen_sample_eval(*r.values(), Z, *sep))


def no_scratch(name, call, Z):
    """``call()``'s outputs, once the allocator saw it allocate no block
    beyond them the size of Z or larger (a second call, after a first one
    made the layout's table)."""
    call()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before - sum(
        -(-t.untyped_storage().nbytes() // 512) * 512 for t in out)
    if extra >= Z.numel() * Z.element_size():
        raise AssertionError(f"{name}: {extra} bytes beyond its outputs, a "
                             f"Z of {tuple(Z.shape)} is "
                             f"{Z.numel() * Z.element_size()}")
    return out


def strategy_kernel_checks(dev, errs):
    """Rows 7 and 8 against their plain versions (module docstring, phase
    2); records the float64 max abs errors in ``errs``."""
    rows = []

    def record(name, label, e, dtype, shape):
        if dtype == torch.float64:
            errs[name] = max(errs[name], e[0])
        rows.append({"kernel": name, "layout": label, "shape": shape,
                     "dtype": str(dtype), "max_abs_err": e[0],
                     "max_rel_err": e[1],
                     **({"repeat_bit_identical": True}
                        if label != "rank_mu_gram" else {})})

    for label, starts, n in strategy_layouts(dev):
        for dtype in (torch.float64, torch.float32):
            a = grouped_inputs(starts, n, dtype, dev, seed=len(starts))
            bdz = (a["B"], a["D"], a["Z"], starts)
            got_y = (cma_sample.sample_groups(*bdz),)
            e_y = compare("cma_sample", got_y, (ref.sample_groups(*bdz),),
                          dtype)
            repeat_on_poison("cma_sample",
                             lambda: (cma_sample.sample_groups(*bdz),), got_y)
            got_x = (cma_sample.sample_groups(*bdz, a["m"], a["sigma"]),)
            e_x = compare("cma_sample affine", got_x,
                          (ref.sample_groups(*bdz, a["m"], a["sigma"]),),
                          dtype)
            repeat_on_poison("cma_sample affine", lambda: (
                cma_sample.sample_groups(*bdz, a["m"], a["sigma"]),), got_x)
            record("cma_sample", label,
                   (max(e_y[0], e_x[0]), max(e_y[1], e_x[1])), dtype,
                   [len(starts) - 1, starts[-1], n])
    for lam, n in RANK_MU_SHAPES:
        for dtype in (torch.float64, torch.float32):
            # one slot; negative weights; a second slot of zero weights
            for label, kw in (("C", {}), ("negative_w", dict(negative=True)),
                              ("zero_w_slot", dict(S=2))):
                u = rank_mu_inputs(lam, n, dtype, dev, **kw)
                args = (u["C"], u["Y"], u["w"], u["p_c"])
                got = cma_update.rank_mu_update(*args, u["coef"])
                e = compare(f"cma_rank_mu_update {label}", (got,),
                            (ref.rank_mu_update(*args,
                                                *u["coef"].unbind(1)),),
                            dtype)
                symmetric("cma_rank_mu_update", got)
                repeat_on_poison(f"cma_rank_mu_update {label}", lambda: (
                    cma_update.rank_mu_update(*args, u["coef"]),), (got,),
                    cma_update.gram_scratch(cma_update.rank_mu_plan(
                        *u["Y"].shape)))
                record("cma_rank_mu_update", label, e, dtype,
                       [u["w"].shape[0], lam, n])
                if label == "C":
                    yw = (u["Y"][0], u["w"][0])
            gram = ops.rank_mu_gram(*yw)
            e_g = compare("cma_rank_mu_update (rank_mu_gram)", (gram,),
                          (ref.rank_mu_gram(*yw),), dtype)
            symmetric("cma_rank_mu_update (rank_mu_gram)", gram)
            record("cma_rank_mu_update", "rank_mu_gram", e_g, dtype,
                   [1, lam, n])
    torch.cuda.synchronize()
    return rows


def rng_prefix_checks(dev):
    """Kernel against kernel, bit for bit, at both widths the bucketed
    paths run (n = 1000 and 40): the first rows and columns of a λ_max call
    are a narrow call at bucket widths 12 and 192 (the bucket property).
    Seed words ≥ 2³¹ are read as unsigned: the kernel's stream is the plain
    version's, whose words are uint32 by construction, and the words'
    int64 twins below 0 give the same bits."""
    out = {}
    for dtype, n in ((d, n) for d in (torch.float64, torch.float32)
                     for n in (MAIN["n"], RESTARTS["n"])):
        S, lam = MAIN["S"], MAIN["lam"]
        a, sep = sample_inputs(S, lam, n, dtype, dev, fid=1)
        r, seeds = rng_args(a), seed_words(S, dev, seed=5)
        wide_z = cma_gen.sample_z_rng(seeds, lam, n, dtype)
        wide_x = cma_gen.gen_sample_rng(*r.values(), seeds, lam)
        wide_f = cma_gen.gen_sample_rng_eval(*r.values(), seeds, lam, *sep)
        for p in (LAM_START, LAM_START << 4):
            same_bits("cma_sample_z_rng prefix",
                      (cma_gen.sample_z_rng(seeds, p, n, dtype),
                       cma_gen.sample_z_rng(seeds, p, 7, dtype)),
                      (wide_z[:, :p], wide_z[:, :p, :7]))
            same_bits("cma_gen_sample_rng prefix",
                      cma_gen.gen_sample_rng(*r.values(), seeds, p),
                      (t[:, :p] for t in wide_x))
            same_bits("cma_gen_sample_rng_eval prefix",
                      cma_gen.gen_sample_rng_eval(*r.values(), seeds, p,
                                                  *sep),
                      (t[:, :p] for t in wide_f))
        high = seeds.clone()
        high[:, 1] = 2 ** 32 - 1 - high[:, 1] % 7
        got = cma_gen.sample_z_rng(high, 64, n, dtype)
        compare("cma_sample_z_rng unsigned seeds", (got,),
                (ref.sample_z_rng(high, 64, n, dtype),), dtype)
        same_bits("cma_sample_z_rng negative twins",
                  (cma_gen.sample_z_rng(high - 2 ** 32, 64, n, dtype),),
                  (got,))
        out[f"{dtype}_n{n}"] = True
    torch.cuda.synchronize()
    return out


def phase_main_path(dev):
    """run_ipop on f8 at full width through the sample and update kernels,
    then the same ladder at n=8 on the card and on the CPU."""
    n, gens, lam_max = MAIN["n"], GENS, MAIN["lam"]
    fn, inst = bbob.make_fitness(8, n, 1, device=dev)
    torch.cuda.synchronize()
    cma_gen.reset_launches()
    t0 = time.perf_counter()
    res = ipop.run_ipop(fn, n, 11, lam_start=LAM_START, kmax_exp=KMAX,
                        max_evals=10**9, total_gens=gens, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cma_gen.LAUNCHES)
    if launches["cma_gen_sample"] != gens or launches["cma_gen_update"] != gens:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"{gens} of the sample and update kernels")
    if not np.isfinite(res.best_f) or res.total_fevals != LAM_START * gens:
        raise AssertionError(f"f8 run: best_f {res.best_f}, fevals "
                             f"{res.total_fevals}")
    d0 = res.descents[0]
    if not (np.isfinite(d0.best_f).all() and (np.diff(d0.best_f) <= 0).all()
            and np.array_equal(d0.gens, np.arange(1, gens + 1))):
        raise AssertionError("f8 run: trace is not a finite best-so-far "
                             "record of every generation")

    # one batched eigh at this width (eigen_interval is 1 at λ_max = 3072,
    # so the ladder runs one every generation; it syncs with the host)
    C = update_inputs(1, LAM_START, n, torch.float64, dev)["C"]
    eigh_ms = time_ms(lambda: cmaes.eigen_decompose(C), reps=3)
    ms_per_gen = wall / gens * 1e3
    emit({"phase": "main_path_f8", "n": n, "lam_max": lam_max, "gens": gens,
          "ms_per_gen": ms_per_gen, "eigh_ms": eigh_ms,
          "launches": launches,
          "best_f_minus_fopt": res.best_f - float(inst.f_opt),
          "padding": {"useful_evals": res.total_fevals,
                      "padded_evals": gens * lam_max},
          "small_ladder_card_vs_cpu_rel_err": small_ladders(dev)})
    return launches, ms_per_gen


def small_ladders(dev):
    """The ladder at n=8 on the card and on the CPU's plain path, f8 (sample
    kernel) and f1/f2 through ``fusable_fitness`` (eval-fused kernel), both
    schedules: every trace leaf must agree (ints exactly, floats to 1e-9).
    Returns the largest relative error per run."""
    small = dict(n=8, lam_start=8, kmax_exp=2, eigen_interval=24,
                 max_evals=10**6)
    worst = {}
    for fid in (8, 1, 2):
        for schedule in ("sequential", "concurrent"):
            traces = []
            for d in (dev, "cpu"):
                fn, inst = bbob.make_fitness(fid, 8, 1, device=d)
                fn = bbob.fusable_fitness(inst, (fid,), fn) \
                    if fid in bbob.FUSABLE_FIDS else fn
                eng = ladder.LadderEngine(**small, schedule=schedule, device=d)
                traces.append(eng.run(3, fn, 24)[1])
            err = 0.0
            for a, b in zip(*traces):
                a, b = a.cpu(), b.cpu()
                if a.dtype.is_floating_point:
                    err = max(err, float(((a - b).abs()
                                          / b.abs().clamp_min(1e-300)).max()))
                elif not torch.equal(a, b):
                    raise AssertionError(f"f{fid} {schedule}: card and CPU "
                                         "ladder traces differ")
            if err > 1e-9:
                raise AssertionError(f"f{fid} {schedule}: card vs CPU ladder "
                                     f"rel err {err:.3e}")
            worst[f"f{fid}_{schedule}"] = err
    return worst


def bucketed_padding(res, lam_start):
    """Useful against padded evaluations of a bucketed ``run_ipop`` result:
    each segment step pays its bucket's width, each executed generation is
    worth its rung's λ."""
    useful = sum(len(d.gens) * d.lam for d in res.descents)
    padded = sum(sg["gens"] * lam_start * 2 ** sg["bucket"]
                 for sg in res.driver["segments"])
    return {"useful_evals": useful, "padded_evals": padded,
            "waste": padded / max(useful, 1)}


def check_bucketed_run(name, log, launches, sample_kernel, n):
    """One call of the in-kernel RNG sample kernel and one update launch
    per segment step, and one pull per boundary.  At width n the RNG call
    draws Z in the kernel (n ≤ 64: no row-5 launch) or launches row 5's
    kernel first (one a step); none of the Z-operand kernels runs."""
    steps = sum(sg["gens"] for sg in log["segments"])
    mine = (sample_kernel, "cma_gen_update") + (
        () if sample_plan.draws_z(n) else ("cma_sample_z_rng",))
    others = {k: v for k, v in launches.items() if k not in mine}
    if any(launches[k] != steps for k in mine) or any(others.values()):
        raise AssertionError(f"{name}: launches {launches} for {steps} "
                             "generations")
    if log["pulls"] != len(log["segments"]) + 1:
        raise AssertionError(f"{name}: {log['pulls']} pulls for "
                             f"{len(log['segments'])} segments")
    return steps


def phase_bucketed_main(dev, ladder_ms_per_gen):
    """Phase 3's problem through the bucketed backend and the in-kernel RNG
    sample kernel, for 64 generations of rung 0."""
    n, gens, lam_max = MAIN["n"], GENS, MAIN["lam"]
    fn, inst = bbob.make_fitness(8, n, 1, device=dev)
    torch.cuda.synchronize()
    cma_gen.reset_launches()
    t0 = time.perf_counter()
    res = ipop.run_ipop(fn, n, 11, lam_start=LAM_START, kmax_exp=KMAX,
                        max_evals=LAM_START * gens, backend="bucketed",
                        impl="kernel_rng", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cma_gen.LAUNCHES)
    steps = check_bucketed_run("bucketed f8", res.driver, launches,
                               "cma_gen_sample_rng", n)
    d0 = res.descents[0]
    if (steps != gens or res.total_fevals != LAM_START * gens
            or not np.isfinite(res.best_f)
            or not np.array_equal(d0.gens, np.arange(1, gens + 1))
            or not (np.diff(d0.best_f) <= 0).all()):
        raise AssertionError(f"bucketed f8 run: {steps} steps, fevals "
                             f"{res.total_fevals}, best_f {res.best_f}")
    padding = bucketed_padding(res, LAM_START)
    if padding["padded_evals"] != padding["useful_evals"]:
        raise AssertionError(f"bucketed f8 run: padding {padding} on rung 0")
    emit({"phase": "bucketed_rng_f8", "n": n, "lam_max": lam_max, "gens": gens,
          "ms_per_gen": wall / gens * 1e3,
          "ladder_ms_per_gen": ladder_ms_per_gen, "launches": launches,
          "segments": res.driver["segments"], "pulls": res.driver["pulls"],
          "padding": padding, "ladder_padded_evals": gens * lam_max,
          "best_f_minus_fopt": res.best_f - float(inst.f_opt)})
    return launches


def f_err(a, b, f_opt):
    """Fitness values ``a`` against ``b``, element by element: ``(err,
    drift)``.  ``err`` is the largest |a − b| relative to |b| + |b − f_opt|,
    the value's own magnitude and never less than |f_opt| (relative to |b|
    alone it would blow up where a record crosses 0 on its way to a
    negative f_opt).  ``drift`` is the largest |a − b| beyond 4 ulp of
    ``b`` relative to |b − f_opt|: how far the two runs drifted apart
    against how far they still are from the optimum.  Non-finite values
    must sit in the same places."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(b)
    if not (np.array_equal(fin, np.isfinite(a))
            and np.array_equal(a[~fin], b[~fin])):
        return float("inf"), float("inf")
    a, b = a[fin], b[fin]
    if not b.size:
        return 0.0, 0.0
    diff, gap = np.abs(a - b), np.abs(b - f_opt)
    err = diff / np.maximum(np.abs(b) + gap, 1e-300)
    excess = np.maximum(diff - 4 * np.spacing(np.abs(b)), 0.0)
    drift = np.divide(excess, gap, out=np.where(excess > 0, np.inf, 0.0),
                      where=gap > 0)
    return float(err.max()), float(drift.max())


def rel_err(a, b, scale):
    """max |a − b| / scale, per slot where ``scale`` is (S,), else per
    element."""
    if scale.shape != a.shape:
        d = (a - b).abs().reshape(a.shape[0], -1).amax(dim=1)
    else:
        d = (a - b).abs()
    return float((d / scale.clamp_min(1e-300)).max())


def compare_small_runs(name, card, cpu, f_opt):
    """Two ``run_bucketed_single`` results (carry, trace): every int
    leaf of the trace and the carry exactly; every float leaf element by
    element, bound by 1e-9 — the best values (trace and carry) by
    ``f_err``, m relative to max(|m|, 1), σ relative to itself, C relative
    to its largest entry, the paths relative to their largest entry.
    Returns the bound errors and, unbound, the drift: the best values'
    (``f_err``) and m against the step scale σ·max D.  best_x is not
    compared: near a converged Rosenbrock optimum a 1e-13 change of f moves
    x along the valley by far more."""
    (c_a, t_a), (c_b, t_b) = card, cpu
    c_a = convert.ladder_carry(convert.to_numpy(c_a), "cpu")
    t_a = ladder.LadderTrace(*(v.cpu() for v in t_a))
    ints = [(f, getattr(t_a, f), getattr(t_b, f)) for f in t_a._fields
            if not getattr(t_a, f).dtype.is_floating_point]
    ints += [(f, getattr(c_a, f), getattr(c_b, f))
             for f in ("k_idx", "incarnation", "active", "total_fevals")]
    ints += [(f"states.{f}", getattr(c_a.states, f), getattr(c_b.states, f))
             for f in ("gen", "last_eigen_gen", "fevals", "hist_count",
                       "stop", "stop_reason", "restarts")]
    for f, x, y in ints:
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: {f} differs between card and CPU")
    sa, sb = c_a.states, c_b.states
    bests = [(t_a.best_f, t_b.best_f), (t_a.global_best, t_b.global_best),
             (c_a.best_f, c_b.best_f), (sa.best_f, sb.best_f)]
    f_errs = [f_err(x, y, f_opt) for x, y in bests]
    errs = {"best_f": max(e for e, _ in f_errs),
            "sigma": rel_err(sa.sigma, sb.sigma, sb.sigma.abs()),
            "m": rel_err(sa.m, sb.m, sb.m.abs().clamp_min(1.0)),
            "C": rel_err(sa.C, sb.C, sb.C.abs().amax(dim=(1, 2))),
            "p_sigma": rel_err(sa.p_sigma, sb.p_sigma,
                               sb.p_sigma.abs().amax(dim=1)),
            "p_c": rel_err(sa.p_c, sb.p_c, sb.p_c.abs().amax(dim=1))}
    drift = {"best_f_vs_gap": max(d for _, d in f_errs),
             "m_vs_step": rel_err(sa.m, sb.m, sb.sigma * sb.D.amax(dim=1))}
    return errs, drift


def phase_small_bucketed(dev):
    """The bucketed path at n=8 on the card and on the CPU, f8 and f1/f2
    through ``fusable_fitness``, under both sampling tiers, compared by
    ``compare_small_runs``; on the card, bucketed against the padded
    ladder: the ints of every executed generation exactly.

    λ_start = 16 = 2n: with fewer than n weighted rows (μ < n) the first
    covariances have a repeated eigenvalue, whose eigenvectors cuSOLVER and
    LAPACK choose differently, and the two runs then sample different
    populations from the same distribution."""
    # 1 500 evaluations: cut from 6 000, then from 3 000, for the script's
    # 1200 s
    kw = dict(n=8, lam_start=16, kmax_exp=2, max_evals=1500)
    worst = {}
    for fid in (8, 1, 2):
        for impl in ("auto", "kernel_rng"):
            runs, fns, log = {}, {}, {}
            for d in (dev, "cpu"):
                fn, inst = bbob.make_fitness(fid, 8, 1, device=d)
                fns[d] = bbob.fusable_fitness(inst, (fid,), fn) \
                    if fid in bbob.FUSABLE_FIDS else fn
                eng = bucketed.BucketedLadderEngine(impl=impl, device=d, **kw)
                runs[d] = bucketed.run_bucketed_single(
                    eng, 3, fns[d], log=log if d == dev else None)
            name = f"f{fid}_{impl}"
            errs, drift = compare_small_runs(name, runs[dev], runs["cpu"],
                                             float(inst.f_opt))
            eng_l = ladder.LadderEngine(schedule="sequential", impl=impl,
                                        device=dev, **kw)
            c_l, t_l = eng_l.run(3, fns[dev])
            c_b, t_b = runs[dev]
            for f in ("k_idx", "gen", "fevals", "stop_reason", "stopped"):
                if not torch.equal(getattr(t_b, f)[t_b.ran],
                                   getattr(t_l, f)[t_l.ran]):
                    raise AssertionError(f"{name}: bucketed and ladder {f} "
                                         "differ on the card")
            if int(c_b.total_fevals) != int(c_l.total_fevals):
                raise AssertionError(f"{name}: bucketed and ladder fevals")
            worst[name] = {"errs": errs, "drift": drift,
                           "gens": int(t_b.ran.sum()),
                           "segments": len(log["segments"]),
                           "fevals": int(c_b.total_fevals)}
    emit({"phase": "small_bucketed_card_vs_cpu", **kw, "runs": worst})
    bad = {name: {k: v for k, v in w["errs"].items() if not v <= 1e-9}
           for name, w in worst.items()}
    if any(bad.values()):
        raise AssertionError(f"card vs CPU errors above 1e-9: {bad}")


def phase_ipop(dev):
    n, budget = RESTARTS["n"], BUDGET
    fn, inst = bbob.make_fitness(1, n, 1, device=dev)
    fit = bbob.fusable_fitness(inst, (1,), fn)
    torch.cuda.synchronize()
    cma_gen.reset_launches()
    t0 = time.perf_counter()
    res = ipop.run_ipop(fit, n, 5, lam_start=LAM_START, kmax_exp=KMAX,
                        max_evals=budget, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cma_gen.LAUNCHES)
    err = res.best_f - float(inst.f_opt)
    lams = [d.lam for d in res.descents]
    if not err <= 1e-8:
        raise AssertionError(f"f1 run: best_f - f_opt = {err}")
    if len(res.descents) < 2:
        raise AssertionError(f"f1 run: {len(res.descents)} descent(s)")
    if any(d.lam != LAM_START * 2 ** d.k_exp for d in res.descents):
        raise AssertionError(f"f1 run: population sizes {lams}")
    if res.total_fevals > budget:
        raise AssertionError(f"f1 run spent {res.total_fevals} > {budget}")
    if launches["cma_gen_sample_eval"] == 0 or launches["cma_gen_update"] == 0:
        raise AssertionError(f"eval-fused path launches {launches}")
    emit({"phase": "ipop_f1_restarts", "n": n, "best_f_minus_fopt": err,
          "descents": [[d.lam, len(d.gens), d.stop_reason]
                       for d in res.descents],
          "total_fevals": res.total_fevals, "wall_s": wall,
          "launches": launches})
    return launches


def phase_bucketed_restarts(dev):
    """Phase 4's run through the bucketed backend and the in-kernel RNG
    eval kernel; then again with the speculative driver, bit-identical.
    Returns the launches and the widest λ the run reached."""
    n, budget = RESTARTS["n"], BUDGET_4B
    fn, inst = bbob.make_fitness(1, n, 1, device=dev)
    fit = bbob.fusable_fitness(inst, (1,), fn)
    kw = dict(lam_start=LAM_START, kmax_exp=KMAX, max_evals=budget,
              impl="kernel_rng")
    torch.cuda.synchronize()
    cma_gen.reset_launches()
    t0 = time.perf_counter()
    res = ipop.run_ipop(fit, n, 5, backend="bucketed", device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cma_gen.LAUNCHES)
    steps = check_bucketed_run("bucketed f1", res.driver, launches,
                               "cma_gen_sample_rng_eval", n)
    err = res.best_f - float(inst.f_opt)
    if not err <= 1e-8:
        raise AssertionError(f"bucketed f1 run: best_f - f_opt = {err}")
    if len(res.descents) < 2 or any(d.lam != LAM_START * 2 ** d.k_exp
                                    for d in res.descents):
        raise AssertionError("bucketed f1 run: descents "
                             f"{[d.lam for d in res.descents]}")
    if res.total_fevals != FEVALS_4B:
        raise AssertionError(f"bucketed f1 run spent {res.total_fevals}, "
                             f"expected {FEVALS_4B}")

    eng = bucketed.BucketedLadderEngine(n=n, overlap=True, device=dev, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    log_o: dict = {}
    res_o = ipop._result_from_ladder(
        eng.full, *bucketed.run_bucketed_single(eng, 5, fit, log=log_o),
        log_o)
    torch.cuda.synchronize()
    wall_o = time.perf_counter() - t0
    same_result("overlap=True", res_o, res)
    segs_o = res_o.driver["segments"]
    emit({"phase": "bucketed_rng_f1_restarts", "n": n,
          "best_f_minus_fopt": err,
          "descents": [[d.lam, len(d.gens), d.stop_reason]
                       for d in res.descents],
          "total_fevals": res.total_fevals, "steps": steps, "wall_s": wall,
          "ms_per_step": wall / steps * 1e3, "launches": launches,
          "segments": len(res.driver["segments"]),
          "pulls": res.driver["pulls"],
          "padding": bucketed_padding(res, LAM_START),
          "overlap": {"wall_s": wall_o, "segments": len(segs_o),
                      "spec_hits": sum(sg["spec_hit"] for sg in segs_o),
                      "spec_s": sum(sg.get("spec_s", 0.0) for sg in segs_o),
                      "sync_s": sum(sg["sync_s"] for sg in segs_o),
                      "pulls": res_o.driver["pulls"]}})
    return launches, max(d.lam for d in res.descents)


def phase_float32(dev):
    """``run_ipop(dtype="float32")`` on f1 (module docstring, phase 4c):
    per backend and tier, the card's run, beside the CPU's for
    ``F32_CPU``."""
    n, budget = F32["n"], F32["budget"]
    runs = {}
    launches = {k: 0 for k in cma_gen.LAUNCHES}
    for backend in ("ladder", "bucketed"):
        for impl in ("auto", "kernel_rng"):
            out = {}
            on_cpu = (backend, impl) in F32_CPU
            for d in (dev, "cpu") if on_cpu else (dev,):
                fn, inst = bbob.make_fitness(1, n, 1, dtype=torch.float32,
                                             device=d)
                fit = bbob.fusable_fitness(inst, (1,), fn)
                torch.cuda.synchronize()
                cma_gen.reset_launches()
                t0 = time.perf_counter()
                res = ipop.run_ipop(fit, n, 5, lam_start=LAM_START,
                                    kmax_exp=KMAX, max_evals=budget,
                                    impl=impl, dtype="float32",
                                    backend=backend, device=d)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                for k, v in cma_gen.LAUNCHES.items():
                    launches[k] += v
                f_opt = float(inst.f_opt)
                err = res.best_f - f_opt
                bound = 8 * float(np.spacing(np.float32(f_opt)))
                lams = [x.lam for x in res.descents]
                where = f"float32 {backend} {impl} on {d}"
                if res.total_fevals != FEVALS_4C:
                    raise AssertionError(f"{where}: fevals "
                                         f"{res.total_fevals}, expected "
                                         f"{FEVALS_4C}")
                if not err <= bound:
                    raise AssertionError(f"{where}: best_f - f_opt = {err} "
                                         f"> {bound}")
                if lams != [LAM_START << k for k in range(len(lams))]:
                    raise AssertionError(f"{where}: population sizes {lams}")
                out["card" if d == dev else "cpu"] = {
                    "fevals": res.total_fevals, "best_f_minus_fopt": err,
                    "descents": [[x.lam, len(x.gens), x.stop_reason]
                                 for x in res.descents], "wall_s": wall}
            runs[f"{backend}_{impl}"] = out
    ran = ("cma_gen_sample_eval", "cma_gen_sample_rng_eval",
           "cma_gen_update")
    if not all(launches[k] for k in ran):
        raise AssertionError(f"float32 runs launched {launches}")
    emit({"phase": "float32_f1", **F32, "f_err_bound": bound, "runs": runs,
          "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# campaigns: phase 2's campaign shapes and phases 4d, 9, 9b, 9c, 9d
# ---------------------------------------------------------------------------

def campaign_sep(n, dtype, dev):
    """Real per-member coefficients of the (1, 2) menu at width n: f1 and
    f2 × instances 1–4 × 2 runs (``CAMPAIGN_SEP``), 16 members, member 5
    made invalid, one slot a member."""
    members = ladder.campaign_members(**CAMPAIGN_SEP)
    inst = ladder.campaign_instances(members, n, dtype, dev)
    sep = bbob.separable_coeffs(inst, CAMPAIGN_SEP["fids"])
    valid = sep.valid.clone()
    valid[5] = False
    return ops.slot_sep(sep._replace(valid=valid), 1, dtype)


def campaign_kernel_checks(dev, errs):
    """Rows 1-4 and 6 at the campaign shapes (module docstring, phase 2):
    S members at (12·2ᵏ, 40), k = 0…8, with the (1, 2) menu's per-member
    coefficients at S = 16; rows 1 and 6 at phase 9d's (24, 3072, 1000).
    Each against its plain version and again, bit for bit, on a second
    launch into NaN-filled memory.  Returns the check rows and the update
    plan at (24, 3072, 1000)."""
    rows = []

    def check(name, S, lam, n, dtype, kern, plain):
        got = kern()
        e = compare(f"{name} at ({S}, {lam}, {n})", got, plain(), dtype)
        repeat_on_poison(f"{name} at ({S}, {lam}, {n})", kern, got)
        record(name, S, lam, n, dtype, e)

    def check_update(S, lam, n, dtype):
        u = update_inputs(S, lam, n, dtype, dev)
        got = poisoned_update(u)
        e = compare(f"cma_gen_update at ({S}, {lam}, {n})", got,
                    ref_update(u), dtype)
        symmetric("cma_gen_update", got[0])
        same_bits(f"cma_gen_update at ({S}, {lam}, {n}) (second launch)",
                  got, poisoned_update(u))
        record("cma_gen_update", S, lam, n, dtype, e)

    def record(name, S, lam, n, dtype, e):
        if dtype == torch.float64:
            errs[name] = max(errs[name], e[0])
        rows.append({"kernel": name, "shape": [S, lam, n],
                     "dtype": str(dtype), "max_abs_err": e[0],
                     "max_rel_err": e[1], "repeat_bit_identical": True})

    n = CAMPAIGN["n"]
    for S in CAMPAIGN_SLOTS:
        for k in range(KMAX + 1):
            lam = LAM_START << k
            for dtype in (torch.float64, torch.float32):
                a, _ = sample_inputs(S, lam, n, dtype, dev, seed=S + k)
                r, seeds = rng_args(a), seed_words(S, dev, seed=lam + S)
                check("cma_gen_sample", S, lam, n, dtype,
                      lambda: cma_gen.gen_sample(**a),
                      lambda: ref.gen_sample(**a))
                check("cma_gen_sample_rng", S, lam, n, dtype,
                      lambda: cma_gen.gen_sample_rng(**r, seeds=seeds,
                                                     lam=lam),
                      lambda: ref.gen_sample_rng(**r, seeds=seeds, lam=lam))
                if S == CAMPAIGN_SEP_SLOTS:
                    sep = campaign_sep(n, dtype, dev)
                    check("cma_gen_sample_eval", S, lam, n, dtype,
                          lambda: kernel_eval(a, sep),
                          lambda: ref.gen_sample_eval(**a, sep=sep))
                    check("cma_gen_sample_rng_eval", S, lam, n, dtype,
                          lambda: cma_gen.gen_sample_rng_eval(
                              *r.values(), seeds, lam, *sep),
                          lambda: ref.gen_sample_rng_eval(
                              *r.values(), seeds, lam, sep))
                check_update(S, lam, n, dtype)
    # phase 10's S1 call: 8 members of the (1, 2) menu at (12, 1000)
    S, lam, n = len(MESH["fids"]) * MESH["runs"], LAM_START, MAIN["n"]
    for dtype in (torch.float64, torch.float32):
        a, _ = sample_inputs(S, lam, n, dtype, dev, seed=S)
        members = ladder.campaign_members(MESH["fids"], (1,), MESH["runs"])
        sep = ops.slot_sep(bbob.separable_coeffs(
            ladder.campaign_instances(members, n, dtype, dev),
            MESH["fids"]), 1, dtype)
        check("cma_gen_sample_eval", S, lam, n, dtype,
              lambda: kernel_eval(a, sep),
              lambda: ref.gen_sample_eval(**a, sep=sep))
        check_update(S, lam, n, dtype)
    S, lam, n = CAMPAIGN_WIDE["members"], MAIN["lam"], MAIN["n"]
    for dtype in (torch.float64, torch.float32):
        a, _ = sample_inputs(S, lam, n, dtype, dev, seed=S)
        check("cma_gen_sample", S, lam, n, dtype,
              lambda: cma_gen.gen_sample(**a), lambda: ref.gen_sample(**a))
        del a
        check_update(S, lam, n, dtype)
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    plan = cma_gen.update_plan(S, lam, n)
    return rows, {"shape": [S, lam, n], "chunks": plan.chunks,
                  "chunk_rows": plan.chunk_rows,
                  "scratch_bytes_f64": 8 * sum(plan.scratch().values())}


def last_rungs(trace, kmax):
    """Per member of a campaign trace: the rung it ends on (one above the
    rung of its last generation if that generation stopped it) and whether
    it retired on the last rung."""
    ran, k = trace.ran[..., 0], trace.k_idx[..., 0]
    stop = trace.stopped[..., 0]
    out = []
    for b in range(ran.shape[0]):
        idx = np.flatnonzero(ran[b])
        if not idx.size:
            out.append((0, False))
            continue
        last_k, stopped = int(k[b, idx[-1]]), bool(stop[b, idx[-1]])
        retired = stopped and last_k == kmax
        out.append((last_k + (stopped and not retired), retired))
    return out


def check_campaign_budget(name, res, budget, lam_start, kmax):
    """Each member spent at most ``budget``, and more than ``budget`` less
    the λ of the rung it ends on unless it retired on the last rung."""
    for b, (k_end, retired) in enumerate(last_rungs(res.trace, kmax)):
        fe = int(res.total_fevals[b])
        short = fe <= budget - (lam_start << k_end)
        if fe > budget or (short and not retired):
            raise AssertionError(f"{name}: member {res.members[b]} spent {fe}"
                                 f" of {budget} ending on rung {k_end}")


def check_campaign_launches(name, launches, steps, sample_kernel):
    """One sample launch and one update launch a step, whatever the member
    count, and no other kernel."""
    mine = (sample_kernel, "cma_gen_update")
    others = {k: v for k, v in launches.items() if k not in mine}
    if any(launches[k] != steps for k in mine) or any(others.values()):
        raise AssertionError(f"{name}: launches {launches} for {steps} "
                             "steps")


def ecdf(res):
    """Per ``bbob.GROUPS`` entry, the share of (member, target) pairs
    reached over ``ECDF_TARGETS`` at the end of the run."""
    hits = np.isfinite(res.hit_evals(ECDF_TARGETS))
    fids = np.array([f for f, _i, _r in res.members])
    return {g: float(hits[np.isin(fids, fs)].mean())
            for g, fs in bbob.GROUPS.items() if np.isin(fids, fs).any()}


def run_bucketed_campaign(dev, name, fids, instances, runs, impl, policy,
                          sample_kernel, budget):
    """``run_campaign_bucketed`` at n = 40 with ``budget`` evaluations a
    member, checked (module docstring, phase 9) and summarised; returns
    the summary, its launches and the widest bucket it ran."""
    n = CAMPAIGN["n"]
    eng = bucketed.BucketedLadderEngine(
        n=n, lam_start=LAM_START, kmax_exp=KMAX, max_evals=budget, impl=impl,
        policy=policy, device=dev)
    torch.cuda.synchronize()
    cma_gen.reset_launches()
    t0 = time.perf_counter()
    res = bucketed.run_campaign_bucketed(eng, fids, instances, runs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cma_gen.LAUNCHES)
    steps = sum(sg["gens"] for sg in res.segments)
    where = f"{name} {policy}"
    check_campaign_launches(where, launches, steps, sample_kernel)
    check_campaign_budget(where, res, budget, LAM_START, KMAX)
    if res.compiles > KMAX + 1:
        raise AssertionError(f"{where}: {res.compiles} programs")
    err = res.best_f - res.f_opt
    f1 = np.array([f == 1 for f, _i, _r in res.members])
    if not (err[f1] <= 1e-8).all():
        raise AssertionError(f"{where}: f1 members at {err[f1]}")
    f2 = np.array([f == 2 for f, _i, _r in res.members])
    return {"members": len(res.members), "policy": policy, "budget": budget,
            "wall_s": wall,
            "steps": steps, "ms_per_step": wall / steps * 1e3,
            "segments": len(res.segments), "pulls": res.pulls,
            "compiles": res.compiles, "padding_waste": res.padding_waste(),
            "useful_evals": res.useful_evals,
            "padded_evals": res.padded_evals,
            "fevals": [int(x) for x in res.total_fevals],
            "f1_best_minus_fopt_max": float(err[f1].max()),
            "f2_best_minus_fopt": [float(x) for x in err[f2]],
            "ecdf": ecdf(res), "launches": launches}, launches, max(
                LAM_START << sg["bucket"] for sg in res.segments)


def campaign_step_split(dev):
    """Where a step of phase 9's campaign goes: its 48 members at bucket 0
    (λ = 12, n = 40) for ``SPLIT_GENS`` generations from the start, once
    with the suite's fitness (24 evaluator calls a step) and once with
    f1's evaluator on every member (one call a step), unprofiled, in the
    order suite, one, suite, one: ms a step each; then the suite's first
    ``SPLIT_PROFILED_GENS`` generations under ``torch.profiler``: ms a
    step, the device's busy ms a step and its kernels with the most
    device time, the aten calls a step, and the host ms a step inside the
    fitness and in the ``aten`` calls that take the most of it
    (``index_select``, ``index_copy_`` and ``linalg_eigh``, which waits
    for the device, among them)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    n, menu = CAMPAIGN["n"], tuple(range(1, 25))
    eng = bucketed.BucketedLadderEngine(
        n=n, lam_start=LAM_START, kmax_exp=KMAX, max_evals=10 ** 9,
        device=dev)
    members = ladder.campaign_members(menu, CAMPAIGN["instances"])
    stacked = ladder.campaign_instances(members, n, torch.float64, dev)
    keys = ladder.member_keys(0, len(members), dev)
    suite = bbob.campaign_fitness(stacked, menu)
    one = bbob.StackedFitness(
        stacked._replace(fid=torch.ones_like(stacked.fid)), (1,))

    def window(fit, gens=SPLIT_GENS):
        run = eng.segment_runner(0, menu, gens)
        carry = eng.init_carry(keys)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(keys, fit, carry)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / gens * 1e3

    def traced(X):
        with record_function("campaign_fitness"):
            return suite(X)
    unprofiled = {"suite": [], "one": []}
    for _ in range(2):
        unprofiled["suite"].append(window(suite))
        unprofiled["one"].append(window(one))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = window(traced, SPLIT_PROFILED_GENS)
    gens = SPLIT_PROFILED_GENS
    evts = prof.key_averages()
    host = {e.key: e for e in evts
            if str(getattr(e, "device_type", "")).endswith("CPU")}
    on_device = [e for e in evts
                 if "CUDA" in str(getattr(e, "device_type", ""))
                 and profile_update.device_us(e) > 0
                 and e.key != "campaign_fitness"]    # the span, not a kernel
    busy_us = sum(profile_update.device_us(e) for e in on_device)
    top = sorted((e for k, e in host.items() if k.startswith("aten::")),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:8]

    def per_step(e):
        return {"calls": e.count / gens,
                "host_ms": e.cpu_time_total / 1e3 / gens,
                "self_host_ms": e.self_cpu_time_total / 1e3 / gens}
    return {"members": len(members), "gens": SPLIT_GENS,
            "profiled_gens": gens, "ms_per_step": unprofiled,
            "profiled_ms_per_step": profiled_ms,
            "device_busy_ms_per_step": busy_us / 1e3 / gens,
            "device_top": {e.key[:80]: {
                "launches": e.count / gens,
                "device_ms": profile_update.device_us(e) / 1e3 / gens}
                for e in sorted(on_device, key=profile_update.device_us,
                                reverse=True)[:6]},
            "aten_calls_per_step": sum(e.count for k, e in host.items()
                                       if k.startswith("aten::")) / gens,
            "fitness": per_step(host["campaign_fitness"]),
            "aten": {k: per_step(host[k]) for k in (
                "aten::index_select", "aten::index_copy_",
                "aten::linalg_eigh") if k in host},
            "aten_top_self": {e.key: per_step(e) for e in top}}


def phase_campaign_n40(dev):
    """Phase 9: all 24 fids × instances (1, 2) through the bucketed driver,
    under both policies.  Returns the launches and the widest bucket."""
    out, launches, widest = {}, {k: 0 for k in cma_gen.LAUNCHES}, 0
    for policy in ("cover", "min"):
        out[policy], ln, wd = run_bucketed_campaign(
            dev, "campaign_bbob24_n40", range(1, 25), CAMPAIGN["instances"],
            1, "auto", policy, "cma_gen_sample", CAMPAIGN["budgets"][policy])
        widest = max(widest, wd)
        for k, v in ln.items():
            launches[k] += v
    emit({"phase": "campaign_bbob24_n40", "n": CAMPAIGN["n"], "runs": out,
          "step_split": campaign_step_split(dev)})
    return launches, widest


def phase_campaign_sep_rng(dev):
    """Phase 9b: the (1, 2) menu under ``kernel_rng`` (row 4, the draw in
    the kernel at n = 40, with mixed per-member coefficients)."""
    summary, launches, widest = run_bucketed_campaign(
        dev, "campaign_sep_rng_n40", CAMPAIGN_SEP["fids"],
        CAMPAIGN_SEP["instances"], CAMPAIGN_SEP["runs"], "kernel_rng",
        "cover", "cma_gen_sample_rng_eval", CAMPAIGN["budget"])
    emit({"phase": "campaign_sep_rng_n40", "n": CAMPAIGN["n"],
          "budget_per_member": CAMPAIGN["budget"], **summary})
    return launches, widest


def near_rounding(fid, inst, X):
    """Rows of X where f7's z (floor of zhat + 1/2 and of 10·zhat + 1/2,
    the |zhat| = 1/2 switch) or f23's (round of z·2ʲ) lies within 1e-12 of
    a boundary (tests/test_torch_bbob.py's rule)."""
    n = X.shape[-1]
    z = bbob._rot(X - inst.x_opt, inst.R)
    if fid == 7:
        zh = z * bbob.lam_alpha(10.0, n, X)
        d = torch.minimum(torch.minimum(
            (zh + 0.5 - torch.round(zh + 0.5)).abs(),
            (10 * zh + 0.5 - torch.round(10 * zh + 0.5)).abs() / 10),
            (zh.abs() - 0.5).abs())
    else:
        z = bbob._rot(z * bbob.lam_alpha(100.0, n, X), inst.Q)
        j = 2.0 ** torch.arange(1, 33, dtype=X.dtype)
        zj = z[..., None] * j
        d = (zj - torch.floor(zj) - 0.5).abs() / j
    return (d.reshape(d.shape[0], -1) < 1e-12).any(-1)


def evaluator_card_vs_cpu(dev):
    """Each of the 24 evaluators at n = 40, one call on 64 rows (the
    optimum among them), the card against the CPU on the same instance:
    per fid the largest relative error and, for f7 and f23, the rows
    excused as rounding-boundary cases."""
    n, out = CAMPAIGN["n"], {}
    rng = np.random.default_rng(9)
    for fid in range(1, 25):
        inst = bbob.make_instance(fid, n, 1, device="cpu")
        X = torch.tensor(rng.uniform(-5, 5, (64, n)))
        X[0] = inst.x_opt
        want = bbob.evaluate(fid, inst, X)
        got = bbob.evaluate(fid, bbob.BBOBInstance(*(x.to(dev) for x in inst)),
                            X.to(dev)).cpu()
        rel = (got - want).abs() / want.abs()
        bad = ~(rel <= EVAL_RTOL.get(fid, 1e-12))
        excused = 0
        if fid in (7, 23):
            near = near_rounding(fid, inst, X)
            excused = int((bad & near).sum())
            bad &= ~near
        if bad.any():
            raise AssertionError(f"f{fid} card vs CPU: rows "
                                 f"{torch.nonzero(bad).flatten().tolist()}"
                                 f" off by {float(rel[bad].max()):.3e}")
        out[fid] = {"max_rel_err": float(rel[~rel.isnan()].max()),
                    **({"boundary_rows": excused} if fid in (7, 23) else {})}
    return out


def phase_campaign_card_vs_cpu(dev):
    """Phase 9c: ``run_campaign`` and ``run_campaign_bucketed`` at n = 8
    on the card and the CPU (``CAMPAIGN_SMALL``), ``auto`` and
    ``kernel_rng``: every int leaf of the traces and the evaluations
    exactly, the best values element by element to 1e-9 (``f_err``); then
    the 24 evaluators card against CPU.  Returns the card runs' launches."""
    c = dict(CAMPAIGN_SMALL)
    fids, instances = c.pop("fids"), c.pop("instances")
    launches = {k: 0 for k in cma_gen.LAUNCHES}
    runs = {}
    for engine in ("ladder", "bucketed"):
        for impl in ("auto", "kernel_rng"):
            res = {}
            for d in (dev, "cpu"):
                cma_gen.reset_launches()
                if engine == "ladder":
                    res[d] = ladder.run_campaign(ladder.LadderEngine(
                        **c, impl=impl, device=d), fids, instances)
                else:
                    res[d] = bucketed.run_campaign_bucketed(
                        bucketed.BucketedLadderEngine(**c, impl=impl,
                                                      device=d),
                        fids, instances)
                if d == dev:
                    torch.cuda.synchronize()
                    for k, v in cma_gen.LAUNCHES.items():
                        launches[k] += v
            card, cpu = res[dev], res["cpu"]
            name = f"{engine}_{impl}"
            for f in ("ran", "k_idx", "gen", "fevals", "stop_reason",
                      "stopped", "total_fevals"):
                if not np.array_equal(getattr(card.trace, f),
                                      getattr(cpu.trace, f)):
                    raise AssertionError(f"9c {name}: trace {f} differs "
                                         "between card and CPU")
            if not np.array_equal(card.total_fevals, cpu.total_fevals):
                raise AssertionError(f"9c {name}: evaluations differ")
            worst = 0.0
            for b in range(len(card.members)):
                for x, y in ((card.best_f[b], cpu.best_f[b]),
                             (card.trace.best_f[b], cpu.trace.best_f[b]),
                             (card.trace.global_best[b],
                              cpu.trace.global_best[b])):
                    worst = max(worst, f_err(x, y, cpu.f_opt[b])[0])
            if not worst <= 1e-9:
                raise AssertionError(f"9c {name}: best values off by "
                                     f"{worst:.3e}")
            runs[name] = {"members": len(card.members), "best_f_err": worst,
                          "fevals": [int(x) for x in card.total_fevals],
                          "gens": int(card.trace.ran.shape[1])}
    emit({"phase": "campaign_card_vs_cpu", **CAMPAIGN_SMALL, "runs": runs,
          "evaluators_n40": evaluator_card_vs_cpu(dev)})
    return launches


def phase_campaign_wide(dev):
    """Phase 9d: ``run_campaign`` (the λ_max-padded ladder) over the 24
    fids × instance 1 at n = 1000 for ``CAMPAIGN_WIDE["gens"]``
    generations: rows 1 and 6 at (24, 3072, 1000), one launch each a
    generation; evaluations from the trace; ms a generation, the batched
    ``eigh`` of the 24 covariances, peak allocated memory."""
    n, gens, S = MAIN["n"], CAMPAIGN_WIDE["gens"], CAMPAIGN_WIDE["members"]
    eng = ladder.LadderEngine(n=n, lam_start=LAM_START, kmax_exp=KMAX,
                              max_evals=10 ** 9, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cma_gen.reset_launches()
    t0 = time.perf_counter()
    res = ladder.run_campaign(eng, range(1, S + 1), (1,), total_gens=gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(cma_gen.LAUNCHES)
    check_campaign_launches("campaign_bbob24_n1000", launches, gens,
                            "cma_gen_sample")
    tr = res.trace
    spent = (tr.ran[..., 0] * (LAM_START << tr.k_idx[..., 0])).sum(1)
    if not np.array_equal(spent, res.total_fevals):
        raise AssertionError(f"9d: evaluations {res.total_fevals}, the "
                             f"trace's {spent}")
    if not np.isfinite(res.best_f).all():
        raise AssertionError(f"9d: best values {res.best_f}")
    if not peak_gb < CAMPAIGN_WIDE["peak_gb"]:
        raise AssertionError(f"9d: peak memory {peak_gb:.2f} GB")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ladder.campaign_instances(ladder.campaign_members(range(1, S + 1)), n,
                              torch.float64, dev)
    torch.cuda.synchronize()
    inst_s = time.perf_counter() - t0
    C = update_inputs(S, LAM_START, n, torch.float64, dev)["C"]
    eigh_ms = time_ms(lambda: cmaes.eigen_decompose(C), reps=3)
    del C
    torch.cuda.empty_cache()
    emit({"phase": "campaign_bbob24_n1000", "members": S, "n": n,
          "lam_max": MAIN["lam"], "gens": gens, "wall_s": wall,
          "instances_s": inst_s, "ms_per_gen": (wall - inst_s) / gens * 1e3,
          "eigh_ms": eigh_ms, "peak_allocated_gb": peak_gb,
          "launches": launches, "fevals": [int(x) for x in res.total_fevals],
          "best_minus_fopt": {f: float(e) for (f, _i, _r), e in zip(
              res.members, res.best_f - res.f_opt)}})
    return launches


def launched_steps(res):
    """The steps a bucketed or mesh run launched: every segment's, and
    with S1's speculative dispatch (``overlap``, records with
    ``spec_hit``) the dropped speculations too, each the length of the
    segment before it: one at every boundary whose bucket changed, and
    one after the last segment."""
    segs = res.segments
    steps = sum(sg["gens"] for sg in segs)
    if segs and "spec_hit" in segs[0]:
        steps += segs[-1]["gens"] + sum(
            prev["gens"] for prev, sg in zip(segs, segs[1:])
            if not sg["spec_hit"])
    return steps


@contextlib.contextmanager
def host_threads(device, n=1):
    """Where ``device`` is the CPU, torch's intra-op threads cut to ``n``
    for the block: the n = 8 ops of the card-vs-CPU runs are too small to
    split, and more threads only add barriers."""
    if torch.device(device).type != "cpu":
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def mesh_run(dev, name, strategy, fids, instances, runs, n, budget, islands,
             impl="auto", mesh_dev=None, lam_start=LAM_START, kmax_exp=KMAX,
             overlap=True):
    """One ``run_campaign_mesh`` on ``islands`` islands of ``mesh_dev``
    (the card by default), with its wall seconds, launches and peak
    allocated memory; on the card each kernel tier's launches are checked:
    S1 one sample and one update launch a step for all members, S2 one of
    each an island a step (``segments`` holds every island's), counting
    S1's dropped speculative segments (``launched_steps``)."""
    where = mesh_dev or dev
    eng = mesh_engine.MeshCampaignEngine(
        n=n, lam_start=lam_start, kmax_exp=kmax_exp, max_evals=budget,
        impl=impl, strategy=strategy, overlap=overlap,
        mesh=make_campaign_mesh(islands, device=where))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cma_gen.reset_launches()
    t0 = time.perf_counter()
    with host_threads(where):
        res = mesh_engine.run_campaign_mesh(eng, fids, instances, runs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cma_gen.LAUNCHES)
    steps = launched_steps(res)
    if torch.device(where).type == "cuda" and impl in ops.KERNEL_TIERS:
        menu_sep = all(f in bbob.FUSABLE_FIDS for f in fids)
        kernel = {("auto", False): "cma_gen_sample",
                  ("auto", True): "cma_gen_sample_eval",
                  ("kernel_rng", False): "cma_gen_sample_rng",
                  ("kernel_rng", True): "cma_gen_sample_rng_eval"}[
                      (impl, menu_sep)]
        check_campaign_launches(f"{name} {strategy}", launches, steps,
                                kernel)
    elif any(launches.values()):
        raise AssertionError(f"{name} {strategy} {impl} on {where}: "
                             f"launches {launches}")
    if res.compiles > kmax_exp + 1:
        raise AssertionError(f"{name} {strategy}: {res.compiles} programs")
    return res, {"strategy": strategy, "islands": islands, "impl": impl,
                 "wall_s": wall, "steps": steps,
                 "segments": len(res.segments),
                 "exchange_rounds": len(res.exchange), "pulls": res.pulls,
                 "compiles": res.compiles,
                 "useful_evals": res.useful_evals,
                 "padded_evals": res.padded_evals,
                 "padding_waste": res.padding_waste(),
                 "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "launches": launches}


def same_campaign(name, got, want, tol=1e-9):
    """Two campaign results: the evaluations and every int leaf of the
    trace exactly, the best values element by element to ``tol``
    (``f_err``); returns the worst float error."""
    for f in ("ran", "k_idx", "gen", "fevals", "stop_reason", "stopped",
              "total_fevals"):
        if not np.array_equal(getattr(got.trace, f), getattr(want.trace, f)):
            raise AssertionError(f"{name}: trace {f} differs")
    if not np.array_equal(got.total_fevals, want.total_fevals):
        raise AssertionError(f"{name}: evaluations {got.total_fevals} "
                             f"against {want.total_fevals}")
    worst = 0.0
    for b in range(len(want.members)):
        for x, y in ((got.best_f[b], want.best_f[b]),
                     (got.trace.best_f[b], want.trace.best_f[b]),
                     (got.trace.global_best[b], want.trace.global_best[b])):
            worst = max(worst, f_err(x, y, want.f_opt[b])[0])
    if not worst <= tol:
        raise AssertionError(f"{name}: best values off by {worst:.3e}")
    return worst


def phase_mesh_n1000(dev):
    """Phase 10: S1 (with and without the speculative segment), S2 and
    ``run_campaign_bucketed`` on the same 8 members at n = 1000 (``MESH``),
    on 8 islands of the card: equal ints, best values within 1e-9; ms a
    generation (S2's also an island's), peak memory.  Returns the
    launches of S1, S2 and the bucketed run."""
    n, budget = MAIN["n"], MESH["budget"]
    args = (MESH["fids"], (1,), MESH["runs"], n, budget, MESH["islands"])
    gens = budget // LAM_START
    out, res, launches = {}, {}, {}
    # the bucketed driver first, the reference: the mesh runs that follow
    # find every kernel, runner and library handle warm
    eng = bucketed.BucketedLadderEngine(n=n, lam_start=LAM_START,
                                        kmax_exp=KMAX, max_evals=budget,
                                        device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cma_gen.reset_launches()
    t0 = time.perf_counter()
    res["bucketed"] = bucketed.run_campaign_bucketed(eng, MESH["fids"], (1,),
                                                     MESH["runs"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["bucketed"] = dict(cma_gen.LAUNCHES)
    check_campaign_launches("mesh_n1000 bucketed", launches["bucketed"],
                            launched_steps(res["bucketed"]),
                            "cma_gen_sample_eval")
    out["bucketed"] = {"wall_s": wall,
                       "peak_allocated_gb":
                       torch.cuda.max_memory_allocated() / 1e9}
    for run, strategy, overlap in (("ordered_no_spec", "ordered", False),
                                   ("ordered", "ordered", True),
                                   ("concurrent", "concurrent", True)):
        res[run], out[run] = mesh_run(dev, "mesh_n1000", strategy, *args,
                                      overlap=overlap)
        launches[run] = out[run].pop("launches")
    for run in ("ordered", "ordered_no_spec", "concurrent"):
        r = res[run]
        out[run]["best_f_err_vs_bucketed"] = same_campaign(
            f"mesh_n1000 {run}", r, res["bucketed"])
        if not (r.trace.ran[..., 0].sum(1) == gens).all():
            raise AssertionError(f"mesh_n1000 {run}: generations "
                                 f"{r.trace.ran[..., 0].sum(1)}")
    for key in out:
        out[key]["ms_per_gen"] = out[key]["wall_s"] / gens * 1e3
    # the islands run one after another: an island's generation is the
    # run's over the islands that ran
    ran = sum(1 for segs in res["concurrent"].shard_segments if segs)
    out["concurrent"]["ms_per_island_gen"] = (
        out["concurrent"]["ms_per_gen"] / ran)
    emit({"phase": "mesh_n1000", "members": len(res["bucketed"].members),
          "n": n, "budget_per_member": budget, "gens": gens,
          "eigen_interval": eng.interval, "runs": out,
          "fevals": [int(x) for x in res["bucketed"].total_fevals],
          "best_minus_fopt": [float(x) for x in
                              res["bucketed"].best_f - res["bucketed"].f_opt]})
    return launches


def phase_mesh_campaign_n40(dev):
    """Phase 10b: phase 9's 48 members (24 fids × instances 1 and 2) at
    n = 40 on 8 islands, ``MESH_CAMPAIGN["budget"]`` evaluations a member,
    under S1 (``overlap=False``) and S2: budgets as phase 9 checks them;
    wall seconds, segments and exchange rounds, padded and useful
    evaluations, padding waste, the ECDF per BBOB group, and the padding
    S2 saves against S1.  Returns per strategy its launches and its
    widest bucket's λ."""
    budget, islands = MESH_CAMPAIGN["budget"], MESH_CAMPAIGN["islands"]
    out, launches, widest = {}, {}, {}
    for strategy in ("ordered", "concurrent"):
        res, out[strategy] = mesh_run(
            dev, "mesh_campaign_n40", strategy, range(1, 25),
            CAMPAIGN["instances"], 1, CAMPAIGN["n"], budget, islands,
            overlap=False)
        launches[strategy] = out[strategy].pop("launches")
        check_campaign_budget(f"mesh_campaign_n40 {strategy}", res, budget,
                              LAM_START, KMAX)
        widest[strategy] = max(LAM_START << sg["bucket"]
                               for sg in res.segments)
        err = res.best_f - res.f_opt
        f1 = np.array([f == 1 for f, _i, _r in res.members])
        out[strategy].update(
            ecdf=ecdf(res), f1_best_minus_fopt_max=float(err[f1].max()),
            fevals_total=int(res.total_fevals.sum()))
    s1, s2 = out["ordered"]["padded_evals"], out["concurrent"]["padded_evals"]
    emit({"phase": "mesh_campaign_n40", "members": 48, "n": CAMPAIGN["n"],
          "islands": islands, "budget_per_member": budget, "runs": out,
          "padded_s2_over_s1": s2 / s1, "padding_saved_by_s2": 1 - s2 / s1})
    return launches, widest


def phase_mesh_card_vs_cpu(dev):
    """Phase 10c: both strategies at n = 8 (``MESH_SMALL``) on 4 islands of
    the card and 4 of the CPU, under ``auto`` and ``kernel_rng``: every int
    leaf and the evaluations exactly, the best values to 1e-9; then
    ``run_ipop(backend="mesh")`` under both strategies, card against CPU
    (``mesh_ipop_card_vs_cpu``); then ``eager`` under S1 and
    ``eager_unfused`` under S2 on the card (``MESH_PLAIN_BUDGET``
    evaluations a member) launch no kernel.  Returns the card runs'
    launches."""
    c = dict(MESH_SMALL)
    fids, runs, islands = c.pop("fids"), c.pop("runs"), c.pop("islands")
    args = (fids, (1,), runs, c["n"], c["max_evals"], islands)
    kw = dict(lam_start=c["lam_start"], kmax_exp=c["kmax_exp"])
    launches = {k: 0 for k in cma_gen.LAUNCHES}
    out = {}
    for impl in ("auto", "kernel_rng"):
        for strategy in ("ordered", "concurrent"):
            card, o = mesh_run(dev, "mesh_card_vs_cpu", strategy, *args,
                               impl=impl, **kw)
            for k, v in o["launches"].items():
                launches[k] += v
            cpu, oc = mesh_run(dev, "mesh_card_vs_cpu", strategy, *args,
                               impl=impl, mesh_dev="cpu", **kw)
            name = f"10c {strategy} {impl}"
            out[f"{strategy}_{impl}"] = {
                "best_f_err": same_campaign(name, card, cpu),
                "fevals": [int(x) for x in card.total_fevals],
                "segments": o["segments"], "card_s": o["wall_s"],
                "cpu_s": oc["wall_s"]}
    out["run_ipop"], ipop_launches = mesh_ipop_card_vs_cpu(dev)
    for k, v in ipop_launches.items():
        launches[k] += v
    plain = (fids, (1,), runs, c["n"], MESH_PLAIN_BUDGET, islands)
    for impl, strategy in (("eager", "ordered"),
                           ("eager_unfused", "concurrent")):
        _r, o = mesh_run(dev, "mesh_card_vs_cpu", strategy, *plain,
                         impl=impl, **kw)
        out[f"{strategy}_{impl}"] = {"launches": sum(
            o["launches"].values()), "card_s": o["wall_s"]}
    emit({"phase": "mesh_card_vs_cpu", **MESH_SMALL, "runs": out})
    return launches



def mesh_ipop_card_vs_cpu(dev):
    """``run_ipop(backend="mesh", mesh_strategy=s)`` for both strategies on
    f1 and f2 (``MESH_IPOP``; one island, on the card and on the CPU): the
    evaluations and every descent's rung, λ, stop reason, generations and
    evaluations equal, the descents' bests and the final best within 1e-9
    (``f_err``), f1 with a restart; on the card one eval-fused sample
    launch and one update launch a step the engine launched (its segments
    read from the engine's ``drive``), counted from 0 just before the
    call.  Returns the per-run records and the card runs' launches."""
    c = dict(MESH_IPOP)
    budgets, n = c.pop("budgets"), c.pop("n")
    drives = []
    drive = mesh_engine.MeshCampaignEngine.drive

    def recorded(self, *args, **kw):
        drives.append(drive(self, *args, **kw))
        return drives[-1]
    mesh_engine.MeshCampaignEngine.drive = recorded
    launches = {k: 0 for k in cma_gen.LAUNCHES}
    out = {}
    try:
        for fid, budget in budgets.items():
            for strategy in ("ordered", "concurrent"):
                res = {}
                for where in (dev, "cpu"):
                    fn, inst = bbob.make_fitness(fid, n, 1, device=where)
                    fit = bbob.fusable_fitness(inst, (fid,), fn)
                    torch.cuda.synchronize()
                    cma_gen.reset_launches()
                    t0 = time.perf_counter()
                    with host_threads(where):
                        res[where] = ipop.run_ipop(
                            fit, n, 11, max_evals=budget, backend="mesh",
                            mesh_strategy=strategy, device=where, **c)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    got = dict(cma_gen.LAUNCHES)
                    name = f"10c run_ipop f{fid} {strategy} on {where}"
                    if where == "cpu":
                        if any(got.values()):
                            raise AssertionError(f"{name}: launches {got}")
                        cpu_s = wall
                        continue
                    card_s, f_opt = wall, float(inst.f_opt)
                    steps = launched_steps(types.SimpleNamespace(
                        segments=drives[-1]["segments"]))
                    check_campaign_launches(name, got, steps,
                                            "cma_gen_sample_eval")
                    for k, v in got.items():
                        launches[k] += v
                card, cpu = res[dev], res["cpu"]
                name = f"10c run_ipop f{fid} {strategy}"
                if card.total_fevals != cpu.total_fevals:
                    raise AssertionError(f"{name}: evaluations "
                                         f"{card.total_fevals} against "
                                         f"{cpu.total_fevals}")
                desc = [[(d.k_exp, d.lam, d.stop_reason) for d in r.descents]
                        for r in (card, cpu)]
                if desc[0] != desc[1] or len(desc[0]) < (2 if fid == 1
                                                         else 1):
                    raise AssertionError(f"{name}: descents {desc}")
                worst = f_err(card.best_f, cpu.best_f, f_opt)[0]
                for dc, dp in zip(card.descents, cpu.descents):
                    if not (np.array_equal(dc.gens, dp.gens)
                            and np.array_equal(dc.fevals, dp.fevals)):
                        raise AssertionError(f"{name}: descent records")
                    worst = max(worst, f_err(dc.best_f, dp.best_f, f_opt)[0])
                if not worst <= 1e-9:
                    raise AssertionError(f"{name}: bests off by {worst:.3e}")
                out[f"f{fid}_{strategy}"] = {
                    "fevals": int(card.total_fevals),
                    "descents": [[d.lam, len(d.gens), d.stop_reason]
                                 for d in card.descents],
                    "best_f_err": worst, "steps": steps, "card_s": card_s,
                    "cpu_s": cpu_s}
    finally:
        mesh_engine.MeshCampaignEngine.drive = drive
    return out, launches


# ---------------------------------------------------------------------------
# phases 11-11c: the campaign service
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def service_steps():
    """Records every segment runner the campaign service hands out, one a
    dispatch: (lane key, bucket, length).  The lengths add up to the
    island steps the service launched."""
    rec = []
    runner = service_server._Lane.runner

    def recorded(self, k, seg_gens):
        rec.append((self.key, int(k), int(seg_gens)))
        return runner(self, k, seg_gens)
    service_server._Lane.runner = recorded
    try:
        yield rec
    finally:
        service_server._Lane.runner = runner


@contextlib.contextmanager
def fresh_obs():
    """An empty process-wide metrics registry and tracer for the block."""
    prev_m = obs.set_metrics(obs.MetricsRegistry())
    prev_t = obs.set_tracer(obs.Tracer())
    try:
        yield obs.metrics(), obs.tracer()
    finally:
        obs.set_metrics(prev_m)
        obs.set_tracer(prev_t)


def same_ipop(name, got, want, f_opt, tol=1e-9, gate=True):
    """Two IPOPResults: the evaluations and every descent's rung, λ, stop
    reason, generations and evaluations equal, the bests within ``tol``
    (``f_err``).  Raises where ``gate``, else returns whether they
    agree; returns the worst best error too."""
    ok = (got.total_fevals == want.total_fevals
          and [(d.k_exp, d.lam, d.stop_reason) for d in got.descents]
          == [(d.k_exp, d.lam, d.stop_reason) for d in want.descents]
          and all(np.array_equal(a.gens, b.gens)
                  and np.array_equal(a.fevals, b.fevals)
                  for a, b in zip(got.descents, want.descents)))
    worst = f_err(got.best_f, want.best_f, f_opt)[0]
    if ok:
        for a, b in zip(got.descents, want.descents):
            worst = max(worst, f_err(a.best_f, b.best_f, f_opt)[0])
    ok = ok and worst <= tol
    if gate and not ok:
        raise AssertionError(f"{name}: {got.total_fevals} against "
                             f"{want.total_fevals} evaluations, descents "
                             f"{[(d.lam, len(d.gens)) for d in got.descents]}"
                             f" against "
                             f"{[(d.lam, len(d.gens)) for d in want.descents]}"
                             f", bests off by {worst:.3e}")
    return ok, worst


def service_jobs():
    """Phase 11's requests: 24 jobs at n = 40 (fid j + 1, instance 1,
    budgets uniform in ``SERVICE["budgets"]`` and priorities 0-2 from
    ``default_rng(0)``), then f1 and f2 at n = 1000."""
    c = SERVICE
    rng = np.random.default_rng(0)
    budgets = rng.integers(c["budgets"][0], c["budgets"][1] + 1, 24)
    prios = rng.integers(0, 3, 24)
    narrow = [CampaignRequest(dim=c["n"], fid=j + 1, budget=int(budgets[j]),
                              seed=100 + j, priority=int(prios[j]))
              for j in range(24)]
    wide = [CampaignRequest(dim=c["wide_n"], fid=f, budget=c["wide_budget"],
                            seed=200 + f) for f in (1, 2)]
    return narrow, wide


def bucketed_jobs(dev, reqs, n):
    """The bucketed engine over ``reqs`` (one dim-class) as one campaign:
    each member on its job's key, instance and budget (``drive_segments``
    with per-member budgets), evaluated as a service lane of the 24-fid
    menu evaluates it (``StackedFitness``, never the eval-fused kernel);
    returns an IPOPResult a job."""
    c = SERVICE
    eng = bucketed.BucketedLadderEngine(
        n=n, lam_start=c["lam_start"], kmax_exp=c["kmax_exp"],
        max_evals=c["max_budget"], device=dev)
    keys = torch.stack([prng.PRNGKey(r.seed, device=dev) for r in reqs])
    insts = bbob.stack_instances([
        bbob.make_instance(r.fid, n, r.instance, eng.full.cfg.tdtype, dev)
        for r in reqs])
    fids = tuple(sorted({r.fid for r in reqs}))
    fit = ops.slot_fitness(bbob.StackedFitness(insts, fids), 1,
                           eng.full.cfg.tdtype)
    budgets = np.array([r.budget for r in reqs], np.int64)
    budgets_t = torch.as_tensor(budgets, device=dev)

    def dispatch(k, g, carry):
        carry, tr = eng.segment_scan(k, keys, fit, carry, g,
                                     max_evals=budgets_t)
        return carry, ladder.member_major(tr)
    carry, trace, _segs, _walls = bucketed.drive_segments(
        eng, eng.init_carry(keys), dispatch, budgets=budgets)
    return [ipop._result_from_ladder(
        eng.full, mesh_engine.tree_map(lambda a, j=j: a[j], carry),
        ladder.LadderTrace(*(x[j] for x in trace))) for j in range(len(reqs))]


def phase_service_stream(dev):
    """Phase 11 ``service_stream_n40``: a campaign service (the 24-fid
    menu, λ_start = 12, kmax_exp = 8, 12 rows an island, one island on the
    card, ``auto``) serving ``service_jobs``: 12 n = 40 jobs and the two
    n = 1000 ones before the first boundary, the other 12 one a boundary
    after it (mid-flight admission, rows reused as jobs retire).  Gates:
    every job done within its budget; the n = 40 lane through at least
    two buckets; one sample (row 1) and one update launch an island step
    and no other kernel; at most 9 programs a lane and none added by a
    later job; one schedule pull a lane a boundary; every f1/f2 job equal
    to the bucketed engine on its key and budget (``bucketed_jobs``, one
    campaign a dim-class; ints exactly, bests within 1e-9).  Prints wall,
    ms a boundary, jobs/s, evaluations/s and useful and padded
    evaluations.  Returns the launches and the widest bucket of the
    n = 40 lane."""
    c = SERVICE
    narrow, wide = service_jobs()
    srv = service_server.CampaignServer(bbob_fids=tuple(range(1, 25)),
                         lam_start=c["lam_start"], kmax_exp=c["kmax_exp"],
                         max_budget=c["max_budget"],
                         rows_per_island=c["rows"],
                         seg_blocks=c["seg_blocks"], devices=[dev])
    with fresh_obs() as (reg, _tr), service_steps() as rec:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cma_gen.reset_launches()
        t0 = time.perf_counter()
        tickets = [srv.submit(r) for r in narrow[:12] + wide]
        for r in narrow[12:]:
            srv.step()
            tickets.append(srv.submit(r))
        srv.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cma_gen.LAUNCHES)
        pulls = {dict(lk)["lane"]: h.count for (nm, lk), h in
                 reg._series.items() if nm == "service_boundary_pull_s"}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    boundaries = srv._boundary_n
    steps = sum(g for _l, _k, g in rec)
    check_campaign_launches("11 service_stream_n40", launches, steps,
                            "cma_gen_sample")
    if set(pulls.values()) != {boundaries} or len(pulls) != 2:
        raise AssertionError(f"11: pulls {pulls} for {boundaries} "
                             "boundaries")
    by_job = {t.job_id: t for t in tickets}
    for t in tickets:
        if not t.done or t.fevals > t.request.budget:
            raise AssertionError(f"11: job {t.job_id} {t.status} spent "
                                 f"{t.fevals} of {t.request.budget}")
    compiles = srv.segment_compiles()
    if compiles > (c["kmax_exp"] + 1) * len(srv.lanes):
        raise AssertionError(f"11: {compiles} programs for "
                             f"{len(srv.lanes)} lanes")
    extra = srv.submit(CampaignRequest(dim=c["n"], fid=1, budget=600,
                                       seed=300))
    srv.drain()
    if not extra.done or srv.segment_compiles() != compiles:
        raise AssertionError("11: a later job added a program")
    useful = sum(t.fevals for t in tickets)
    padded = sum(c["rows"] * g * (c["lam_start"] << k) for _l, k, g in rec)
    buckets = sorted({k for key, k, _g in rec if key[0] == c["n"]})
    if len(buckets) < 2:
        raise AssertionError(f"11: the n = {c['n']} lane ran buckets "
                             f"{buckets} only: no job climbed a rung")
    t0 = time.perf_counter()
    # the gate: every f1/f2 job against the bucketed engine, one campaign
    # a dim-class
    worst = 0.0
    for n in (c["n"], c["wide_n"]):
        sel = [t for t in tickets
               if t.request.dim == n and t.request.fid in (1, 2)]
        refs = bucketed_jobs(dev, [t.request for t in sel], n)
        for t, want in zip(sel, refs):
            r = t.request
            f_opt = float(bbob.make_instance(r.fid, n, r.instance,
                                             device="cpu").f_opt)
            worst = max(worst, same_ipop(
                f"11 job {t.job_id} (f{r.fid}, n={n})", t.result, want,
                f_opt)[1])
    gate_s = time.perf_counter() - t0
    widest = c["lam_start"] << buckets[-1]
    emit({"phase": "service_stream_n40", **{k: v for k, v in c.items()},
          "jobs": len(tickets), "wall_s": wall, "boundaries": boundaries,
          "ms_per_boundary": wall / boundaries * 1e3,
          "jobs_per_s": len(tickets) / wall,
          "evals_per_s": useful / wall, "useful_evals": useful,
          "padded_evals": padded, "padding_waste": padded / useful,
          "island_steps": steps, "segments": len(rec),
          "segment_compiles": compiles, "pulls": pulls,
          "peak_allocated_gb": peak_gb, "n40_buckets": buckets,
          "f1_f2_best_err": worst, "f1_f2_reference_s": gate_s,
          "fevals": {j: t.fevals for j, t in by_job.items()},
          "launches": launches})
    return launches, widest


def phase_service_snapshot(dev):
    """Phase 11b (``service_snapshot_runs``): the launches of its three
    runs and the widest λ they ran."""
    with service_steps() as rec:
        launches = service_snapshot_runs(dev)
    return launches, SERVICE["lam_start"] << max(k for _l, k, _g in rec)


def service_snapshot_runs(dev):
    """Phase 11b ``service_snapshot_resume``: 6 jobs at n = 40
    (``SERVICE_SNAPSHOT``) on one island: uninterrupted, and snapshotted
    at that run's middle boundary, dropped, restored into a new server and
    drained: every job's ints and bests bit-identical; the same snapshot
    restored onto two islands of the card (re-packed): ints equal, bests
    within 1e-9.  Returns the launches of the three runs."""
    c = SERVICE
    reqs = [CampaignRequest(dim=c["n"], fid=f,
                            budget=SERVICE_SNAPSHOT["budget"], seed=400 + i)
            for i, f in enumerate(SERVICE_SNAPSHOT["fids"])]
    kw = dict(bbob_fids=tuple(range(1, 25)), lam_start=c["lam_start"],
              kmax_exp=c["kmax_exp"], max_budget=c["max_budget"],
              rows_per_island=c["rows"], seg_blocks=c["seg_blocks"])
    cma_gen.reset_launches()
    t0 = time.perf_counter()
    ref = service_server.CampaignServer(devices=[dev], **kw)
    want = [ref.submit(r) for r in reqs]
    ref.drain()
    out = {"uninterrupted_s": time.perf_counter() - t0,
           "boundaries": ref._boundary_n}
    snap_at = max(1, ref._boundary_n // 2)
    f_opts = [float(bbob.make_instance(r.fid, r.dim, r.instance,
                                       device="cpu").f_opt) for r in reqs]
    with tempfile.TemporaryDirectory() as td:
        srv = service_server.CampaignServer(devices=[dev], snapshot_dir=td,
                                            **kw)
        for r in reqs:
            srv.submit(r)
        for _ in range(snap_at):
            srv.step()
        t0 = time.perf_counter()
        step = srv.snapshot()
        out["snapshot_s"] = time.perf_counter() - t0
        del srv
        for islands in (1, 2):
            t0 = time.perf_counter()
            back = service_server.CampaignServer.restore(
                td, mesh=make_campaign_mesh(islands, device=dev))
            out[f"restore_{islands}_s"] = time.perf_counter() - t0
            back.drain()
            worst = 0.0
            for j, w in enumerate(want):
                got = back.tickets[w.job_id].result
                if islands == 1:
                    same = (got.total_fevals == w.result.total_fevals
                            and got.best_f == w.result.best_f
                            and all(a.k_exp == b.k_exp
                                    and a.stop_reason == b.stop_reason
                                    and all(np.array_equal(x, y) for x, y
                                            in zip(a[2:5], b[2:5]))
                                    for a, b in zip(got.descents,
                                                    w.result.descents)))
                    if not same:
                        raise AssertionError(f"11b: job {j} not "
                                             "bit-identical after restore")
                else:
                    worst = max(worst, same_ipop(
                        f"11b job {j} on 2 islands", got, w.result,
                        f_opts[j])[1])
            out[f"drain_{islands}_islands_best_err"] = worst
    launches = dict(cma_gen.LAUNCHES)
    emit({"phase": "service_snapshot_resume", **SERVICE_SNAPSHOT,
          "step": step, **out,
          "fevals": [t.fevals for t in want], "launches": launches})
    return launches


def phase_service_card_vs_cpu(dev):
    """Phase 11c (``service_card_vs_cpu``): the card runs' launches and the
    widest λ the servers ran."""
    with service_steps() as rec:
        launches = service_card_vs_cpu(dev)
    return launches, SERVICE_SMALL["lam_start"] << max(k for _l, k, _g
                                                       in rec)


def service_card_vs_cpu(dev):
    """Phase 11c ``service_card_vs_cpu`` at n = 8 (λ_start = 16, kmax_exp =
    2): a server with the (1, 2, 8) menu and a custom sphere serving f1,
    f2, f8 and the sphere (two before the first boundary, two after), on
    the card and on the CPU: ints equal, bests within 1e-9, the card one
    sample (row 1) and one update launch an island step; its metrics JSONL
    schema-valid line by line, its Chrome trace valid, one
    ``service_boundary_pull_s`` observation a boundary.  Then
    ``run_ipop(backend="service")`` against ``backend="bucketed"`` on the
    card (f1 through ``fusable_fitness``, a restart): the same evaluations
    and descents, bests within 1e-9, one sample and one update launch a
    launched step each, the bucketed run's ``bucketed_sync_s`` count its
    pulls.  Then a server of the (1, 2) menu alone on f1 and f2 under
    ``auto`` (row 2 only) against ``eager`` on the card (no kernel), and
    ``kernel_rng`` (row 4 only) against ``kernel_rng`` on the CPU (its own
    stream): ints equal, bests within 1e-9.  Returns the card runs'
    launches."""
    c = SERVICE_SMALL
    kw = dict(lam_start=c["lam_start"], kmax_exp=c["kmax_exp"],
              max_budget=c["budget"] * 2, rows_per_island=4)

    def sphere(X):
        return torch.sum((X - 1.2) ** 2, dim=-1)
    reqs = [CampaignRequest(dim=c["n"], fid=1, budget=c["budget"], seed=500),
            CampaignRequest(dim=c["n"], fid=8, budget=c["budget"], seed=501),
            CampaignRequest(dim=c["n"], fid=2, budget=c["budget"], seed=502),
            CampaignRequest(dim=c["n"], fitness="sphere",
                            budget=c["budget"], seed=503)]
    f_opt = {f: float(bbob.make_instance(f, c["n"], 1, device="cpu").f_opt)
             for f in (1, 2, 8)}
    # ``f_err`` scales an error by the value and never below |f_opt|; the
    # sphere's minimum is 0, where the two devices' sum orders leave
    # relative differences of order 1e-9 on values of order 1e-15, so its
    # floor is 1, its value one unit from the optimum
    f_opts = [f_opt.get(r.fid, 1.0) for r in reqs]
    launches = {k: 0 for k in cma_gen.LAUNCHES}
    res, out = {}, {}
    with tempfile.TemporaryDirectory() as td:
        for where in (dev, "cpu"):
            reg = service_server.FitnessRegistry()
            reg.register("sphere", sphere)
            mpath = os.path.join(td, f"m_{torch.device(where).type}.jsonl")
            with fresh_obs() as (mreg, tracer), service_steps() as rec, \
                    host_threads(where):
                srv = service_server.CampaignServer(
                    registry=reg, bbob_fids=(1, 2, 8), devices=[where],
                    metrics_out=mpath, **kw)
                torch.cuda.synchronize()
                cma_gen.reset_launches()
                t0 = time.perf_counter()
                ts = [srv.submit(r) for r in reqs[:2]]
                for _ in range(2):
                    srv.step()
                ts += [srv.submit(r) for r in reqs[2:]]
                srv.drain()
                torch.cuda.synchronize()
                out[f"{torch.device(where).type}_s"] = \
                    time.perf_counter() - t0
                got = dict(cma_gen.LAUNCHES)
                pulls = sum(h.count for (nm, _lk), h in mreg._series.items()
                            if nm == "service_boundary_pull_s")
                chrome = os.path.join(td, "trace.json")
                tracer.export_chrome(chrome)
            res[where] = [t.result for t in ts]
            if pulls != srv._boundary_n:
                raise AssertionError(f"11c: {pulls} pulls for "
                                     f"{srv._boundary_n} boundaries")
            for line in obs.read_jsonl(mpath):
                for m in line["metrics"]:
                    spec = obs.SPECS[m["name"]]
                    if (m["type"] != spec.kind or sorted(m["labels"])
                            != sorted(spec.labels)):
                        raise AssertionError(f"11c: metric line {m}")
            with open(chrome) as fh:
                bad = obs.validate_chrome(json.load(fh))
            if bad:
                raise AssertionError(f"11c: Chrome trace {bad[:3]}")
            if torch.device(where).type == "cuda":
                check_campaign_launches("11c mixed menu", got,
                                        sum(g for *_x, g in rec),
                                        "cma_gen_sample")
                for k, v in got.items():
                    launches[k] += v
            elif any(got.values()):
                raise AssertionError(f"11c: launches on the CPU {got}")
        out["mixed_best_err"] = max(
            same_ipop(f"11c job {j} card vs CPU", a, b, f_opts[j])[1]
            for j, (a, b) in enumerate(zip(res[dev], res["cpu"])))

    # run_ipop(backend="service") against backend="bucketed" on the card
    fn, inst = bbob.make_fitness(1, c["n"], 1, device=dev)
    fit = bbob.fusable_fitness(inst, (1,), fn)
    ikw = dict(lam_start=c["lam_start"], kmax_exp=c["kmax_exp"],
               max_evals=c["ipop_budget"], device=dev)
    runs, steps = {}, {}
    for backend in ("bucketed", "service"):
        with fresh_obs() as (mreg, _t), service_steps() as rec:
            torch.cuda.synchronize()
            cma_gen.reset_launches()
            runs[backend] = ipop.run_ipop(fit, c["n"], 11, backend=backend,
                                          **ikw)
            torch.cuda.synchronize()
            got = dict(cma_gen.LAUNCHES)
            syncs = mreg.histogram("bucketed_sync_s").count
        if backend == "bucketed":
            steps[backend] = sum(sg["gens"]
                                 for sg in runs[backend].driver["segments"])
            if syncs != runs[backend].driver["pulls"]:
                raise AssertionError(f"11c: {syncs} bucketed_sync_s for "
                                     f"{runs[backend].driver['pulls']} "
                                     "pulls")
            kernel = "cma_gen_sample_eval"
        else:
            steps[backend] = sum(g for *_x, g in rec)
            kernel = "cma_gen_sample"
        check_campaign_launches(f"11c run_ipop {backend}", got,
                                steps[backend], kernel)
        for k, v in got.items():
            launches[k] += v
    out["run_ipop"] = {
        "fevals": runs["service"].total_fevals,
        "descents": [[d.lam, len(d.gens), d.stop_reason]
                     for d in runs["service"].descents],
        "steps": steps, "best_f_err": same_ipop(
            "11c run_ipop service vs bucketed", runs["service"],
            runs["bucketed"], float(inst.f_opt))[1]}
    if len(runs["service"].descents) < 2:
        raise AssertionError("11c: run_ipop made no restart")

    # the (1, 2) menu alone: the eval-fused kernels, or none.  eager is
    # auto's plain version on the card; kernel_rng draws another stream,
    # so its plain version is the same server on the CPU
    sep = [CampaignRequest(dim=c["n"], fid=f, budget=c["sep_budget"],
                           seed=600 + f) for f in (1, 2)]
    plain = {}
    for impl, where, kernel in (
            ("eager", dev, None), ("auto", dev, "cma_gen_sample_eval"),
            ("kernel_rng", "cpu", None),
            ("kernel_rng", dev, "cma_gen_sample_rng_eval")):
        with service_steps() as rec, host_threads(where):
            srv = service_server.CampaignServer(
                bbob_fids=(1, 2), impl=impl, devices=[where], **kw)
            torch.cuda.synchronize()
            cma_gen.reset_launches()
            ts = [srv.submit(r) for r in sep]
            srv.drain()
            torch.cuda.synchronize()
            got = dict(cma_gen.LAUNCHES)
        if kernel is None:
            if any(got.values()):
                raise AssertionError(f"11c: launches under {impl} on "
                                     f"{where}: {got}")
            plain["auto" if impl == "eager" else impl] = [t.result
                                                          for t in ts]
            continue
        check_campaign_launches(f"11c (1, 2) menu {impl}", got,
                                sum(g for *_x, g in rec), kernel)
        for k, v in got.items():
            launches[k] += v
        out[f"sep_{impl}_best_err"] = max(
            same_ipop(f"11c (1, 2) menu {impl} against its plain version",
                      t.result, p, f_opt[f])[1]
            for t, p, f in zip(ts, plain[impl], (1, 2)))
    emit({"phase": "service_card_vs_cpu", **c, **out, "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# phase 12: fleet supervision
# ---------------------------------------------------------------------------

def replayed_steps(records):
    """The steps a recovery ran again: the generations of the segment
    records it dropped (those between the snapshot and the death) and,
    where the driver speculated (S1's records carry ``spec_hit``), each
    speculation that missed inside that window.  The first boundary after
    a recovery speculates nothing, as the first boundary of a run."""
    steps = sum(r["gens"] for r in records)
    if records and "spec_hit" in records[0]:
        steps += sum(prev["gens"] for prev, r in zip(records, records[1:])
                     if not r["spec_hit"])
    return steps


def fleet_counters(reg):
    """The fleet's counters and histograms of one run's registry: kills,
    recoveries by mode, pull retries, rebalances, recovery wall and lost
    work (sums), and the service's snapshot host seconds."""
    out = {"failures": 0, "recoveries": {}, "pull_retries": 0,
           "rebalances": {}, "recovery_wall_s": 0.0, "lost_work_evals": 0.0,
           "service_snapshot_s": [0, 0.0]}
    for (name, lk), s in reg._series.items():
        lab = dict(lk)
        if name == "fleet_failures_total":
            out["failures"] += int(s.value)
        elif name == "fleet_recoveries_total":
            out["recoveries"][lab["mode"]] = int(s.value)
        elif name == "fleet_pull_retries_total":
            out["pull_retries"] += int(s.value)
        elif name == "fleet_rebalances_total":
            out["rebalances"][lab["trigger"]] = int(s.value)
        elif name == "fleet_recovery_wall_s":
            out["recovery_wall_s"] += s.sum
        elif name == "fleet_lost_work_evals":
            out["lost_work_evals"] += s.sum
        elif name == "service_snapshot_s":
            out["service_snapshot_s"] = [s.count, s.sum]
    return out


@contextlib.contextmanager
def made_supervisors():
    """Every engine supervisor ``run_ipop(fleet=...)`` makes in the block
    (``ipop._fleet_supervisor``), for its snapshot host times."""
    made = []
    real = ipop._fleet_supervisor

    def record(fleet):
        made.append(real(fleet))
        return made[-1]
    ipop._fleet_supervisor = record
    try:
        yield made
    finally:
        ipop._fleet_supervisor = real


def fleet_gates(name, got_l, base_l, replay, kernel, counters, kills,
                retries=False):
    """A supervised run against its fault-free run: the fault-free run's
    sample and update launches plus one of each a replayed step, no other
    kernel; exactly the plan's kills graded dead (the health detector
    fired on nothing else) and a replayed recovery for each; a corrupt
    read re-pulled where the plan has one."""
    want = {k: v + (replay if k in (kernel, "cma_gen_update") else 0)
            for k, v in base_l.items()}
    if got_l != want or not got_l[kernel]:
        raise AssertionError(f"{name}: launches {got_l}, expected {want} "
                             f"({replay} steps replayed)")
    if counters["failures"] != kills or \
            counters["recoveries"].get("replayed", 0) != kills:
        raise AssertionError(f"{name}: {counters} for {kills} kills")
    if retries and counters["pull_retries"] < 1:
        raise AssertionError(f"{name}: the corrupt read was not re-pulled")


def timed_run(call):
    """``call()`` on a fresh registry, counted from 0: ``(result, wall s,
    launches, registry)``."""
    with fresh_obs() as (reg, _tr):
        torch.cuda.synchronize()
        cma_gen.reset_launches()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return res, wall, dict(cma_gen.LAUNCHES), reg


def phase_fleet_bucketed(dev, impl):
    """Phase 12a under ``impl``: ``run_ipop(backend="bucketed")`` on f1
    through the eval-fused kernels (``FLEET``), fault-free and with island
    0 killed at boundary 3 (snapshots every 2 boundaries), under ``auto``
    (row 2) or ``kernel_rng`` (row 4); under ``auto`` also a plan of a
    10 ms delay at boundary 1 and a corrupt read at boundary 2, which must
    be re-pulled.  Each supervised result bit-identical to the fault-free
    one, launches per ``fleet_gates``.  Returns the records, the launches
    and the widest λ."""
    c = FLEET
    fn, inst = bbob.make_fitness(1, c["n"], 1, device=dev)
    fit = bbob.fusable_fitness(inst, (1,), fn)
    kw = dict(lam_start=c["lam_start"], kmax_exp=c["kmax_exp"],
              max_evals=c["budget"], backend="bucketed", device=dev)
    kill = ("supervised", [FaultEvent(KILL, 0, c["kill"])])
    plans = {"auto": [kill, ("corrupt_delay",
                             [FaultEvent(DELAY, 0, 1, delay_s=0.01),
                              FaultEvent(CORRUPT, 0, 2)])],
             "kernel_rng": [kill]}
    kernel = {"auto": "cma_gen_sample_eval",
              "kernel_rng": "cma_gen_sample_rng_eval"}[impl]
    launches = {k: 0 for k in cma_gen.LAUNCHES}
    base, base_s, base_l, _r = timed_run(
        lambda: ipop.run_ipop(fit, c["n"], 7, impl=impl, **kw))
    steps = sum(sg["gens"] for sg in base.driver["segments"])
    check_campaign_launches(f"12a {impl} fault-free", base_l, steps,
                            kernel)
    widest = max(d.lam for d in base.descents)
    rec = {"fault_free_s": base_s, "steps": steps,
           "fevals": base.total_fevals,
           "descents": [[d.lam, len(d.gens), d.stop_reason]
                        for d in base.descents]}
    for k, v in base_l.items():
        launches[k] += v
    for tag, events in plans[impl]:
        cfg = FleetConfig(snapshot_every=c["snapshot_every"],
                          plan=FaultPlan(events))
        with made_supervisors() as made:
            got, got_s, got_l, reg = timed_run(
                lambda: ipop.run_ipop(fit, c["n"], 7, impl=impl,
                                      fleet=cfg, **kw))
        name = f"12a {impl} {tag}"
        same_result(name, got, base)
        replay = replayed_steps(got.driver["replayed"])
        counters = fleet_counters(reg)
        kills = sum(e.kind == KILL for e in events)
        fleet_gates(name, got_l, base_l, replay, kernel, counters,
                    kills, retries=tag == "corrupt_delay")
        if kills and not replay:
            raise AssertionError(f"{name}: the kill replayed nothing")
        snaps = made[0].snapshot_s
        rec[tag] = {
            "plan": [[e.kind, e.island, e.boundary]
                     for e in cfg.plan.events],
            "wall_s": got_s, "replayed_steps": replay,
            "pulls": got.driver["pulls"], **counters,
            "snapshots": len(snaps),
            "snapshot_host_ms": 1e3 * sum(snaps) / max(len(snaps), 1)}
        for k, v in got_l.items():
            launches[k] += v
    return rec, launches, widest


def phase_fleet_mesh(dev):
    """Phase 12b: the mesh engine on 2 islands of the card
    (``run_mesh_single``, the engine ``run_ipop(backend="mesh")`` drives,
    on a 2-island mesh), f1 through the eval-fused kernel at 1 000
    evaluations in segments of 16 generations, S2 and S1,
    fault-free and with island 0 killed at round (S1: boundary) 2,
    snapshots every 2: bit-identical, launches per ``fleet_gates`` (S1's
    speculative segments counted by ``launched_steps``).  Returns the
    records, the launches of each strategy and the widest λ."""
    c = FLEET
    fn, inst = bbob.make_fitness(1, c["n"], 1, device=dev)
    fit = bbob.fusable_fitness(inst, (1,), fn)
    out, launches, widest = {}, {}, 0
    for strategy in ("concurrent", "ordered"):
        runs = {}
        for fleet in (None, FleetConfig(
                snapshot_every=c["snapshot_every"],
                plan=FaultPlan([FaultEvent(KILL, 0, c["mesh_kill"])]))):
            eng = mesh_engine.MeshCampaignEngine(
                n=c["n"], lam_start=c["lam_start"], kmax_exp=c["kmax_exp"],
                max_evals=c["mesh_budget"], strategy=strategy,
                seg_blocks=c["mesh_seg_blocks"],
                mesh=make_campaign_mesh(c["mesh_islands"], device=dev))
            drives = []
            drive = eng.drive

            def recorded(*args, **kw):
                drives.append(drive(*args, **kw))
                return drives[-1]
            eng.drive = recorded
            sup = None if fleet is None else IslandSupervisor(fleet)
            (carry, trace), wall, got_l, reg = timed_run(
                lambda: mesh_engine.run_mesh_single(eng, 7, fit,
                                                    supervisor=sup))
            res = ipop._result_from_ladder(
                eng.bucketed.full, carry, trace,
                {"segments": drives[-1]["segments"]})
            runs[fleet is None] = (res, wall, got_l, reg, drives[-1], sup)
        (base, base_s, base_l, _r, base_d, _s) = runs[True]
        (got, got_s, got_l, reg, got_d, sup) = runs[False]
        name = f"12b {strategy}"
        steps = launched_steps(types.SimpleNamespace(
            segments=base_d["segments"]))
        check_campaign_launches(f"{name} fault-free", base_l, steps,
                                "cma_gen_sample_eval")
        same_result(name, got, base)
        replay = replayed_steps(got_d["replayed"])
        counters = fleet_counters(reg)
        fleet_gates(name, got_l, base_l, replay, "cma_gen_sample_eval",
                    counters, 1)
        if not replay:
            raise AssertionError(f"{name}: the kill replayed nothing")
        widest = max(widest, max(d.lam for d in base.descents))
        out[strategy] = {
            "fault_free_s": base_s, "wall_s": got_s, "steps": steps,
            "replayed_steps": replay, "fevals": base.total_fevals,
            **counters, "snapshots": len(sup.snapshot_s),
            "snapshot_host_ms": 1e3 * sum(sup.snapshot_s)
            / max(len(sup.snapshot_s), 1)}
        launches[strategy] = {k: base_l[k] + got_l[k] for k in base_l}
    return out, launches, widest


def fleet_jobs():
    """Phase 12c's requests at n = 40: f1 and f8 of the menu and a shifted
    sphere (a registered callable), budgets 2 000-2 500."""
    n = FLEET_SERVICE["n"]
    return [CampaignRequest(dim=n, fid=1, budget=2500, seed=700),
            CampaignRequest(dim=n, fid=8, budget=2000, seed=701),
            CampaignRequest(dim=n, fitness="shifted", budget=2000,
                            seed=702),
            CampaignRequest(dim=n, fid=1, budget=2000, seed=703)]


def shifted_sphere(X):
    return torch.sum((X - 1.2) ** 2, dim=-1)


def phase_fleet_service(dev, kill_run):
    """Phase 12c's ``kill_run``: ``fleet_jobs`` on a campaign service of 2
    islands of the card (``FLEET_SERVICE``: the (1, 8) menu and the
    callable, so row 1), fault-free, then under a ``FleetController``
    (snapshots every 2 boundaries) with island 1 killed at boundary 3 for
    2 boundaries: ``"reassign_rejoin"`` with 4 rows an island (its rows
    reassigned to island 0, the island rejoins and the lane is repacked),
    ``"park"`` with 2 rows an island (its rows park until it rejoins).
    Every job's evaluations equal to the fault-free server's and its best
    within 1e-12; the 4-row servers' ``segment_compiles`` equal; one
    sample and one update launch an island step; exactly one kill graded
    dead.  Returns the records, the launches and the widest λ."""
    c = FLEET_SERVICE
    f_opts = [float(bbob.make_instance(r.fid, r.dim, r.instance,
                                       device="cpu").f_opt)
              if r.fid is not None else 1.0 for r in fleet_jobs()]

    def server(rows, snapshot_dir=None):
        reg = service_server.FitnessRegistry()
        reg.register("shifted", shifted_sphere)
        return service_server.CampaignServer(
            registry=reg, bbob_fids=(1, 8), lam_start=c["lam_start"],
            kmax_exp=c["kmax_exp"], max_budget=2500, rows_per_island=rows,
            seg_blocks=c["seg_blocks"], devices=[dev] * c["islands"],
            snapshot_dir=snapshot_dir)
    out, launches, widest = {}, {k: 0 for k in cma_gen.LAUNCHES}, 0
    ref = None
    with tempfile.TemporaryDirectory() as td:
        for tag, rows, fleet in (
                ("fault_free", c["rows"], None),
                (kill_run, {"reassign_rejoin": c["rows"],
                            "park": c["small_rows"]}[kill_run], True)):
            srv = server(rows, os.path.join(td, tag) if fleet else None)
            ctl = (None if fleet is None else FleetController(
                srv, FleetConfig(snapshot_every=2, plan=FaultPlan(
                    [FaultEvent(KILL, *c["kill"][:2],
                                down_for=c["kill"][2])]))))
            with service_steps() as rec:
                def drain():
                    ts = [srv.submit(r) for r in fleet_jobs()]
                    (srv if ctl is None else ctl).drain()
                    return ts
                ts, wall, got_l, reg = timed_run(drain)
            steps = sum(g for *_x, g in rec)
            name = f"12c {tag}"
            check_campaign_launches(name, got_l, steps, "cma_gen_sample")
            for k, v in got_l.items():
                launches[k] += v
            widest = max(widest, c["lam_start"] << max(k for _l, k, _g
                                                       in rec))
            counters = fleet_counters(reg)
            rec_out = {"wall_s": wall, "boundaries": srv._boundary_n,
                       "island_steps": steps,
                       "segment_compiles": srv.segment_compiles(),
                       **counters}
            if ref is None:
                ref = (ts, srv.segment_compiles())
                out[tag] = rec_out
                continue
            if counters["failures"] != 1 or any(not t.done for t in ts):
                raise AssertionError(f"{name}: {counters}, statuses "
                                     f"{[t.status for t in ts]}")
            worst = max(same_ipop(f"{name} job {j}", t.result, w.result,
                                  f_opts[j], tol=1e-12)[1]
                        for j, (t, w) in enumerate(zip(ts, ref[0])))
            rc = counters["recoveries"]
            if tag == "reassign_rejoin":
                if (rc.get("reassigned", 0) < 1 or rc.get("rejoined") != 1
                        or not counters["rebalances"].get("rejoin")
                        or srv.segment_compiles() != ref[1]):
                    raise AssertionError(f"{name}: {counters}, programs "
                                         f"{srv.segment_compiles()} against "
                                         f"{ref[1]}")
            elif rc.get("requeued", 0) < 1 or rc.get("rejoined") != 1:
                raise AssertionError(f"{name}: no row parked: {counters}")
            rec_out["best_err"] = worst
            snaps = counters["service_snapshot_s"]
            rec_out["snapshot_host_ms"] = 1e3 * snaps[1] / max(snaps[0], 1)
            out[tag] = rec_out
    return out, launches, widest


def phase_fleet(dev, part):
    """Phase 12's ``part``: 12a ``bucketed_auto`` or
    ``bucketed_kernel_rng``, 12b ``mesh``, 12c ``service_reassign_rejoin``
    or ``service_park``, one line with its records (the five run at once,
    each first in a worker of its own: ``GROUPS``).  Returns its launches
    and the widest λ it reached."""
    fn, arg = {"bucketed_auto": (phase_fleet_bucketed, "auto"),
               "bucketed_kernel_rng": (phase_fleet_bucketed, "kernel_rng"),
               "mesh": (phase_fleet_mesh, None),
               "service_reassign_rejoin": (phase_fleet_service,
                                           "reassign_rejoin"),
               "service_park": (phase_fleet_service, "park")}[part]
    t0 = time.perf_counter()
    res, launches, widest = fn(dev) if arg is None else fn(dev, arg)
    emit({"phase": f"fleet_{part}", **FLEET,
          **({"service_config": FLEET_SERVICE}
             if part.startswith("service") else {}),
          "seconds": time.perf_counter() - t0, part: res})
    return launches, widest


def phase_hostloop(dev):
    """Phase 4d: ``run_ipop(backend="hostloop")`` on f1 through the
    eval-fused kernel at n = 40: a host read per chunk; the budget spent
    up to less than the λ of the rung that could not start; f_opt + 1e-8
    reached."""
    n, budget = HOSTLOOP["n"], HOSTLOOP["budget"]
    fn, inst = bbob.make_fitness(1, n, 1, device=dev)
    fit = bbob.fusable_fitness(inst, (1,), fn)
    torch.cuda.synchronize()
    cma_gen.reset_launches()
    t0 = time.perf_counter()
    res = ipop.run_ipop(fit, n, 5, lam_start=LAM_START, kmax_exp=KMAX,
                        max_evals=budget, backend="hostloop", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cma_gen.LAUNCHES)
    err = res.best_f - float(inst.f_opt)
    last = res.descents[-1]
    unspent = budget - res.total_fevals
    gens = sum(len(d.gens) for d in res.descents)
    steps = launches["cma_gen_sample_eval"]
    others = {k: v for k, v in launches.items()
              if k not in ("cma_gen_sample_eval", "cma_gen_update")}
    if not err <= 1e-8:
        raise AssertionError(f"hostloop f1: best_f - f_opt = {err}")
    if unspent < 0 or (last.k_exp < KMAX and unspent >= 2 * last.lam):
        raise AssertionError(f"hostloop f1: {res.total_fevals} of {budget} "
                             f"spent, last λ {last.lam}")
    if (steps != launches["cma_gen_update"] or steps < gens
            or any(others.values())):
        raise AssertionError(f"hostloop f1: launches {launches} for {gens} "
                             "generations")
    emit({"phase": "hostloop_f1", "n": n, "budget": budget,
          "best_f_minus_fopt": err, "total_fevals": res.total_fevals,
          "descents": [[d.lam, len(d.gens), d.stop_reason]
                       for d in res.descents],
          "gens": gens, "steps": steps, "wall_s": wall,
          "ms_per_step": wall / steps * 1e3, "launches": launches})
    return launches


#: the ``__global__`` functions of ``kernels/csrc``
CSRC_KERNELS = ("tile_kernel", "stream_kernel", "eval_reduce_kernel",
                "z_rng_kernel", "gram_kernel", "vec_small_kernel",
                "t_kernel", "whiten_kernel", "paths_kernel",
                "epilogue_kernel", "rank_mu_epilogue", "flash_f32_kernel",
                "flash_bf16_kernel", "wkv6_kernel", "flash_bwd_dq_kernel",
                "flash_bwd_dkv_kernel", "flash_bwd_prep_kernel",
                "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel",
                "flash_bwd_sum_kernel", "wkv_bwd_pairs_kernel",
                "wkv_bwd_sweep_kernel", "du_reduce_kernel")
#: one of them in a profiled kernel's name, demangled (a whole word) or
#: mangled (after its length)
CSRC_KERNEL_NAME = re.compile("|".join(
    rf"(?<![A-Za-z_]){k}(?![A-Za-z0-9_])|{len(k)}{k}" for k in CSRC_KERNELS))


def phase_no_fallback(dev):
    """A small ladder (f1, n = 8, eval-fused) under each tier on the card,
    under ``torch.profiler``: the plain tiers (``eager``,
    ``eager_unfused``) launch no kernel of ``kernels/csrc`` (no count, no
    profiled kernel of ``CSRC_KERNELS``), ``auto`` does (both)."""
    from torch.profiler import ProfilerActivity, profile
    fn, inst = bbob.make_fitness(1, 8, 1, device=dev)
    fit = bbob.fusable_fitness(inst, (1,), fn)
    out = {}
    for impl in ("eager", "eager_unfused", "auto"):
        eng = ladder.LadderEngine(n=8, lam_start=8, kmax_exp=1,
                                  max_evals=10 ** 6, impl=impl, device=dev)
        torch.cuda.synchronize()
        cma_gen.reset_launches()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.run(3, fit, 8)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        kernels = [e for e in prof.key_averages()
                   if profile_update.device_us(e) > 0]
        found = {e.key[:80]: e.count for e in kernels
                 if CSRC_KERNEL_NAME.search(e.key)}
        counted = sum(cma_gen.LAUNCHES.values())
        out[impl] = {"profiled": found, "counted": counted,
                     "device_kernels": len(kernels), "run_s": t1 - t0,
                     "read_s": time.perf_counter() - t1}
        kernel_tier = impl == "auto"
        if kernel_tier != bool(found) or kernel_tier != bool(counted):
            raise AssertionError(
                f"no-fallback check, impl={impl}: profiled {found}, counted "
                f"{counted}, device kernels "
                f"{sorted(e.key[:60] for e in kernels)[:20]}")
    emit({"phase": "no_fallback", "runs": out})


def phase_strategies(dev):
    """``run_concurrent`` at full width on f8 (module docstring, phase 6)."""
    n, P, gens = STRAT["n"], STRAT["P"], STRAT["gens"]
    fn, inst = bbob.make_fitness(8, n, 1, device=dev)
    torch.cuda.synchronize()
    cma_gen.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    kd, carry, tr = ladder.run_concurrent(n, P, 13, fn, gens,
                                          lam_start=LAM_START, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = dict(cma_gen.LAUNCHES)
    per_gen = kd.n_active * LAM_START                         # 6132
    others = {k: v for k, v in launches.items() if k != "cma_sample"}
    if launches["cma_sample"] != gens or any(others.values()):
        raise AssertionError(f"strategies launches {launches}, expected "
                             f"{gens} of cma_sample and no other kernel")
    if not (np.array_equal(tr["fevals"], per_gen * np.arange(1, gens + 1))
            and int(carry.fevals.sum()) == per_gen * gens):
        raise AssertionError(f"strategies fevals {tr['fevals']}, expected "
                             f"{per_gen} a generation")
    best = tr["best_f"]
    if not (np.isfinite(best).all() and (np.diff(best) <= 0).all()
            and np.isfinite(tr["gen_best"]).all()):
        raise AssertionError("strategies f8: best values not a finite "
                             "best-so-far record")
    if peak >= 4e9:
        raise AssertionError(f"strategies peak memory {peak} B >= 4 GB")
    # one batched eigh of the nine covariances: the lazy mode decomposes
    # every descent each generation (eigen_interval is 1 at λ_max = 3072)
    eigh_ms = time_ms(lambda: cmaes.eigen_decompose(carry.states.C), reps=3)
    ms_per_gen = wall / gens * 1e3
    emit({"phase": "strategies_kdist_f8", "n": n, "n_devices": P,
          "descents": kd.n_descents, "lam_max": kd.lam_max,
          "eigen_interval": kd.cfg.eigen_interval, "gens": gens,
          "ms_per_gen": ms_per_gen, "launches": launches,
          "cma_sample_per_gen": launches["cma_sample"] / gens,
          "fevals": int(tr["fevals"][-1]), "fevals_per_gen": per_gen,
          "best_f_minus_fopt": float(best[-1]) - float(inst.f_opt),
          "peak_allocated_bytes": peak, "eigh_ms": eigh_ms,
          "eigh_share": eigh_ms / ms_per_gen,
          "restarts": carry.restarts.tolist()})
    return launches


def leaf_err(a, b):
    """max |a − b| relative to the largest |b| of each slot (the leading
    axis of a leaf with two or more axes; of the whole leaf otherwise);
    non-finite values must sit in the same places."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.array_equal(np.isfinite(a), np.isfinite(b)):
        return float("inf")
    rows = b.shape[0] if b.ndim >= 2 else 1
    a2 = np.where(np.isfinite(b), a, 0.0).reshape(rows, -1)
    b2 = np.where(np.isfinite(b), b, 0.0).reshape(rows, -1)
    scale = np.maximum(np.abs(b2).max(axis=1), 1e-300)
    return float((np.abs(a2 - b2).max(axis=1) / scale).max())


def compare_tree(name, card, cpu, f_opt, best_fields):
    """Two dicts of numpy leaves: ints exactly; best values by ``f_err``
    (|f| + |f − f_opt|), every other float leaf by ``leaf_err``.  Returns
    the worst error of each float leaf."""
    errs = {}
    for k, b in cpu.items():
        a, b = np.asarray(card[k]), np.asarray(b)
        if a.shape != b.shape:
            raise AssertionError(f"{name}: {k} shapes {a.shape} {b.shape}")
        if b.dtype.kind != "f":
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: {k} differs between card "
                                     "and CPU")
        elif k in best_fields:
            errs[k] = f_err(a, b, f_opt)[0]
        else:
            errs[k] = leaf_err(a, b)
    return errs


def _kdist_leaves(carry, trace):
    out = {f"trace.{k}": v for k, v in trace.items()}
    out.update({f"carry.{f}": getattr(carry, f).cpu().numpy()
                for f in carry._fields if f != "states"})
    out.update({f"states.{f}": getattr(carry.states, f).cpu().numpy()
                for f in carry.states._fields})
    return out


def _krep_leaves(res):
    out = {"fevals": np.asarray(res["fevals"]), "best_f": res["best_f"],
           "best_x": res["best_x"], "phases": np.asarray(len(res["phases"]))}
    for i, ph in enumerate(res["phases"]):
        out.update({f"phase{i}.{k}": np.asarray(v) for k, v in ph.items()})
    return out


def phase_small_strategies(dev):
    """K-Distributed and K-Replicated at n=8 on the card and on the CPU
    (module docstring, phase 6b); λ_start = 16 = 2n, so μ ≥ n and no
    covariance has a repeated eigenvalue (phase 3c)."""
    best = {"trace.best_f", "trace.gen_best", "trace.descent_best",
            "carry.best_f", "states.best_f", "states.f_hist", "best_f"}
    best |= {f"phase{i}.{k}" for i in range(4)
             for k in ("best_f", "group_best")}
    runs = {}
    cma_gen.reset_launches()
    for fid in (1, 2):
        for what in ("kdist_stacked", "kdist_central", "krep"):
            leaves = {}
            for d in (dev, "cpu"):
                fn, inst = bbob.make_fitness(fid, SMALL["n"], 1, device=d)
                if what == "krep":
                    kr = strategies.KReplicated(n_devices=8, impl="auto",
                                                device=d, **SMALL)
                    leaves[d] = _krep_leaves(kr.run_sim(3, fn, 24))
                else:
                    kd = strategies.KDistributed(
                        n_devices=7, comm=what.split("_")[1], impl="auto",
                        device=d, **SMALL)
                    leaves[d] = _kdist_leaves(*kd.run_sim(3, fn, 48))
            name = f"f{fid}_{what}"
            runs[name] = compare_tree(name, leaves[dev], leaves["cpu"],
                                      float(inst.f_opt), best)
    torch.cuda.synchronize()
    launches = dict(cma_gen.LAUNCHES)
    worst = {name: max(e.values()) for name, e in runs.items()}
    emit({"phase": "small_strategies_card_vs_cpu", **SMALL,
          "launches": launches, "worst_err": worst, "errs": runs})
    bad = {name: {k: v for k, v in e.items() if not v <= 1e-9}
           for name, e in runs.items()}
    if any(bad.values()):
        raise AssertionError(f"card vs CPU errors above 1e-9: {bad}")
    if launches["cma_sample"] == 0:
        raise AssertionError("the small card runs launched no cma_sample")
    return launches


def phase_krep_n1000(dev):
    """``KReplicated.run_sim`` at n=1000 on the card, one phase at a time
    (module docstring, phase 6c)."""
    fn, inst = bbob.make_fitness(8, KREP["n"], 1, device=dev)
    kr = strategies.KReplicated(n=KREP["n"], n_devices=KREP["P"],
                                impl="auto", device=dev)
    torch.cuda.synchronize()
    cma_gen.reset_launches()
    phases = []
    for k in range(kr.kmax_exp + 1):
        t0 = time.perf_counter()
        out = kr.run_sim(17, fn, KREP["gens"], phases=[k])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ph = out["phases"][0]
        gens = len(ph["fevals"])
        if (gens != KREP["gens"] or out["fevals"]
                != gens * KREP["P"] * LAM_START
                or not np.isfinite(out["best_f"])):
            raise AssertionError(f"krep phase {k}: {gens} generations, "
                                 f"fevals {out['fevals']}")
        phases.append({"k_exp": k, "lam": ph["lam"], "groups": ph["n_groups"],
                       "gens": gens, "ms_per_gen": wall / gens * 1e3,
                       "best_f_minus_fopt": out["best_f"]
                       - float(inst.f_opt)})
    launches = dict(cma_gen.LAUNCHES)
    steps = sum(p["gens"] for p in phases)
    if launches["cma_sample"] != steps:
        raise AssertionError(f"krep launches {launches} for {steps} "
                             "generations")
    emit({"phase": "strategies_krep_n1000", "n": KREP["n"],
          "n_devices": KREP["P"], "phases": phases, "launches": launches})
    return launches


def strategy_kernel_rows(dev, errs, launches):
    """Rows 7 and 8 of the ``kernels`` line (module docstring, phase 5)."""
    layouts = {label: (starts, n)
               for label, starts, n in strategy_layouts(dev)}
    paths7 = {"strategies_kdist_f8": ["kdist_f8"],
              "strategies_krep_n1000": [lb for lb in layouts
                                        if lb.startswith("krep_n1000")],
              "strategies_small_card_vs_cpu": [
                  lb for lb in layouts if lb.endswith("small")
                  or lb.startswith("krep_small")]}

    def timed(kern, plain, lib, flops, nbytes):
        b_ms, b_by = bound(flops, nbytes, torch.float64)
        return {"ms": time_ms(kern), "plain_ms": time_ms(plain),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(lib)}

    def work7(label):
        starts, n = layouts[label]
        a = grouped_inputs(starts, n, torch.float64, dev)
        bdz = (a["B"], a["D"], a["Z"], starts)
        G, R = len(starts) - 1, starts[-1]
        zd = (a["Z"] * a["D"][0]).contiguous()
        bt = a["B"][0].transpose(0, 1)
        return {"layout": label, "groups": G, "rows": R, "n": n, **timed(
            lambda: cma_sample.sample_groups(*bdz),
            lambda: ref.sample_groups(*bdz), lambda: torch.matmul(zd, bt),
            2.0 * R * n * n, 8 * (2 * R * n + G * n * n + G * n))}

    def work8(lam, n):
        u = rank_mu_inputs(lam, n, torch.float64, dev)
        args = (u["C"], u["Y"], u["w"], u["p_c"])
        lam_nz = int((u["w"] != 0).sum())
        yt = u["Y"][0].transpose(0, 1)
        wy = (u["w"][0, :, None] * u["Y"][0]).contiguous()

        def kern():
            return cma_update.rank_mu_update(*args, u["coef"])
        return {"shape": [1, lam, n], **timed(
            kern, lambda: ref.rank_mu_update(*args, *u["coef"].unbind(1)),
            lambda: torch.matmul(yt, wy),
            n * (n + 1) * lam_nz + 2.5 * n * (n + 1),
            8 * (2 * n * n + lam_nz * n + lam + n + 3)),
            "profile": profile_update.profile_call(kern, 20)}

    paths = {"cma_sample": {
        p: {"launches": launches[p]["cma_sample"],
            "layouts": [work7(lb) for lb in lbs]}
        for p, lbs in paths7.items()},
        "cma_rank_mu_update": {
            p: {"launches": launches[p]["cma_rank_mu_update"]}
            for p in launches}}
    shapes8 = [work8(*shape) for shape in RANK_MU_SHAPES]
    paths["cma_rank_mu_update"]["phase_2_shapes"] = shapes8
    tops = {"cma_sample": paths["cma_sample"]["strategies_kdist_f8"]
            ["layouts"][0],
            "cma_rank_mu_update": shapes8[1]}          # (3072, 1000)
    return [{"name": name, "route": "cuda", "source": SOURCES[name][0],
             "replaces": SOURCES[name][1],
             "launches": sum(launches[p][name] for p in launches),
             "max_abs_err": errs[name],
             **{k: tops[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")},
             "paths": paths[name]} for name in tops]


# ---------------------------------------------------------------------------
# the LM substrate: rows 9-10 and phases 7, 7b, 7c and 8
# ---------------------------------------------------------------------------

def flash_inputs(B, S, H, Hk, D, dtype, dev, seed=0):
    """q (B, S, H, D), k and v (B, S, Hk, D), standard normal."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                         device=dev).to(dtype)
            for shape in ((B, S, H, D), (B, S, Hk, D), (B, S, Hk, D))]


def wkv_inputs(B, S, H, D, dtype, dev, seed=0):
    """The WKV kernel's operands: r, k, v in ``dtype``; logw clamped to
    [−5, −1e−6], u and a non-zero initial state in f32."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.tensor(a, dtype=torch.float32, device=dev).to(dt)
    shape = (B, S, H, D)
    return dict(r=t(rng.standard_normal(shape), dtype),
                k=t(rng.standard_normal(shape), dtype),
                v=t(rng.standard_normal(shape), dtype),
                logw=t(np.clip(-np.exp(rng.standard_normal(shape)), -5.0,
                               -1e-6)),
                u=t(0.1 * rng.standard_normal((H, D))),
                state=t(0.5 * rng.standard_normal((B, H, D, D))))


def lm_kernel_checks(dev, errs):
    """Rows 9 and 10 against their plain versions (module docstring, phase
    2); records the float32 max abs errors in ``errs``."""
    rows = []

    def record(name, e, dtype, shape, **kw):
        if dtype == torch.float32:
            errs[name] = max(errs[name], e[0])
        rows.append({"kernel": name, "shape": shape, "dtype": str(dtype),
                     "max_abs_err": e[0], "max_rel_err": e[1],
                     "max_elem_ratio": e[2], **kw})

    # the serving shape, mid-tile windows, and a ragged S with every
    # template width and a non-causal call
    flash = [dict(c, causal=True) for c in (
        FLASH_CHECKS + list(family_flash_shapes().values()))] + [
        dict(B=2, S=129, H=4, Hk=4, D=32, window=0, causal=True),
        dict(B=1, S=384, H=8, Hk=1, D=128, window=0, causal=True),
        dict(B=1, S=256, H=4, Hk=2, D=64, window=0, causal=False)]
    for c in flash:
        for dtype in (torch.bfloat16, torch.float32):
            shape = [c[k] for k in ("B", "S", "H", "Hk", "D")]
            q, k, v = flash_inputs(*shape, dtype, dev, seed=c["S"])
            kw = dict(causal=c["causal"], window=c["window"])
            got = flash_attention.flash_attention(q, k, v, **kw)
            want = ref.flash_attention(q, k, v, **kw)
            e = lm_compare("flash_attention", (got,), (want,), dtype)
            repeat_on_poison("flash_attention", lambda: (
                flash_attention.flash_attention(q, k, v, **kw),), (got,))
            record("flash_attention", e, dtype, shape,
                   repeat_bit_identical=True, **kw)
            del q, k, v, got, want
    wkv = [WKV_CHECK, dict(B=1, S=32, H=2, D=32), dict(B=1, S=128, H=1, D=128)]
    for c in wkv:
        for dtype in (torch.bfloat16, torch.float32):
            shape = [c[k] for k in ("B", "S", "H", "D")]
            a = wkv_inputs(*shape, dtype, dev, seed=c["S"])
            args = [a[k] for k in ("r", "k", "v", "logw", "u")]
            o, st = rwkv6_wkv.wkv6_forward(*args, a["state"])
            o_ref, st_ref = ref.wkv_chunked(*args, a["state"])
            e_o = lm_compare("wkv6_forward o", (o,), (o_ref,), dtype)
            e_s = lm_compare("wkv6_forward state", (st,), (st_ref,), dtype)
            o0, st0 = rwkv6_wkv.wkv6_forward(*args)
            o0_ref, st0_ref = ref.wkv_chunked(*args, torch.zeros_like(st))
            e_0 = lm_compare("wkv6_forward zero state", (o0, st0),
                             (o0_ref, st0_ref), dtype)
            repeat_on_poison("wkv6_forward", lambda: rwkv6_wkv.wkv6_forward(
                *args, a["state"]), (o, st))
            repeat_on_poison("wkv6_forward zero state",
                             lambda: rwkv6_wkv.wkv6_forward(*args), (o0, st0))
            es = (e_o, e_s, e_0)            # the ratio is None in float32
            record("wkv6_forward", tuple(
                None if e_o[i] is None else max(e[i] for e in es)
                for i in range(3)), dtype, shape, state_max_rel_err=e_s[1],
                repeat_bit_identical=True)
    torch.cuda.synchronize()
    return rows


def lm_grad_checks(dev, errs):
    """Rows 11 and 12 against their plain versions, and row 9's training
    statistic (module docstring, phase 2); records the float32 max abs
    errors in ``errs``."""
    rows = []

    def record(name, e, dtype, shape, **kw):
        if dtype == torch.float32:
            errs[name] = max(errs[name], e[0])
        rows.append({"kernel": name, "shape": shape, "dtype": str(dtype),
                     "max_abs_err": e[0], "max_rel_err": e[1],
                     "max_elem_ratio": e[2], "repeat_bit_identical": True,
                     **kw})

    def grads_compare(name, got, want):
        """Each output in its own type: bf16 by ``lm_compare``'s element
        rule, f32 within LM_GRAD_TOL of its largest |value|."""
        es = []
        for i, (g, w) in enumerate(zip(got, want)):
            if g.dtype == torch.bfloat16:
                es.append(lm_compare(f"{name}[{i}]", (g,), (w,), g.dtype,
                                     LM_GRAD_ROW_SHARE))
            else:
                es.append((*compare(f"{name}[{i}]", (g.float(),),
                                    (w.float(),), torch.float32,
                                    LM_GRAD_TOL), None))
        ratios = [e[2] for e in es if e[2] is not None]
        return (max(e[0] for e in es), max(e[1] for e in es),
                max(ratios) if ratios else None)

    for c in FLASH_BWD_CHECKS:
        for dtype in (torch.bfloat16, torch.float32):
            shape = [c[k] for k in ("B", "S", "H", "Hk", "D")]
            q, k, v = flash_inputs(*shape, dtype, dev, seed=c["S"] + 1)
            do = flash_inputs(c["B"], c["S"], c["H"], 1, c["D"], dtype, dev,
                              seed=c["S"] + 2)[0]
            kw = dict(causal=c["causal"], window=c["window"])
            # the training forward: the serving call's o, bit for bit, and
            # the row statistic against the plain one
            o, lse = flash_attention.flash_attention_stats(q, k, v, **kw)
            same_bits("flash_attention (with stats)", (o,),
                      (flash_attention.flash_attention(q, k, v, **kw),))
            o_ref = ref.flash_attention(q, k, v, **kw)
            lse_ref = ref.flash_attention_lse(q, k, **kw)
            e_lse = compare("flash_attention lse", (lse,), (lse_ref,),
                            torch.float32, LM_TOL[torch.float32])

            def bwd():
                return flash_attention.flash_attention_bwd(
                    q, k, v, o_ref, lse_ref, do, **kw)
            got = bwd()
            want = ref.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, **kw)
            e = grads_compare("flash_attention_bwd", got, want)
            scratch = flash_attention.bwd_scratch_floats(
                dtype, c["B"], c["S"], c["S"], c["H"], c["D"]) * 4 \
                // q.element_size()
            repeat_on_poison("flash_attention_bwd", bwd, got,
                             scratch=scratch)
            record("flash_attention_bwd", e, dtype, shape, **kw,
                   lse_max_rel_err=e_lse[1])
    for c in WKV_BWD_CHECKS:
        for dtype in (torch.bfloat16, torch.float32):
            shape = [c[k] for k in ("B", "S", "H", "D")]
            a = wkv_inputs(*shape, dtype, dev, seed=c["S"] + 3)
            b = wkv_inputs(*shape, dtype, dev, seed=c["S"] + 4)
            args = [a[k] for k in ("r", "k", "v", "logw", "u")]
            do, ds = b["r"], 0.2 * b["state"]
            B, S, H, D = shape
            scratch = rwkv6_wkv.bwd_scratch_floats(B, S, H, D) * 4 \
                // do.element_size()
            for state, dstate in ((a["state"], ds), (None, None)):
                def bwd():
                    return rwkv6_wkv.wkv6_backward(*args, state, do, dstate)
                got = bwd()
                want = ref.wkv_backward(*args, state, do, dstate)
                e = grads_compare("wkv6_backward", got, want)
                repeat_on_poison("wkv6_backward", bwd, got, scratch=scratch)
                record("wkv6_backward", e, dtype, shape,
                       initial_state=state is not None)
    torch.cuda.synchronize()
    return rows


def profiled(fn, top=8):
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA): its host
    time (slowed by the profiler), the device's busy time (the sum of every
    kernel's own device time; one stream, so no overlap), the busy share,
    the aten calls made (nested ones counted) and the ``top`` kernels and
    operators by own device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = profile_update.device_us
    evts = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in evts
                  if getattr(e, "device_type", None) is not None
                  and "CUDA" in str(e.device_type)) / 1e3
    rows = sorted(evts, key=dev_us, reverse=True)[:top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "aten_calls": sum(e.count for e in prof.key_averages()
                              if str(getattr(e, "device_type", "")).endswith(
                                  "CPU") and e.key.startswith("aten::")),
            "top": [{"name": e.key[:80], "count": e.count,
                     "device_ms": dev_us(e) / 1e3} for e in rows]}


def phase_serve(dev, arch):
    """``Engine.generate`` at full width (module docstring, phases 7, 7b):
    prefill, decode, launches, memory, and the first decode step's logits
    against a full forward over the prompt and the first new token."""
    sv = SERVE[arch]
    B, S, new, kernel = sv["B"], sv["S"], sv["new"], sv["kernel"]
    cfg = launcher.serve_config(arch)
    _build.reset_launches()
    launcher.main(["--arch", arch])
    torch.cuda.synchronize()
    via_cli = dict(_build.LAUNCHES)
    torch.cuda.empty_cache()
    if via_cli[kernel] != cfg.n_layers or any(
            v for k, v in via_cli.items() if k != kernel):
        raise AssertionError(f"{arch} launcher launches {via_cli}, expected "
                             f"{cfg.n_layers} of {kernel} and no other")
    eng = Engine(cfg, lm.init_params(cfg, 0, dev), max_len=S + new,
                 device=dev)
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=S,
                                        dtype=np.int32), max_new_tokens=new)
            for _ in range(B)]
    # warm-up at the same shapes (cuBLAS picks its kernels on first use)
    eng.generate([Request(prompt=r.prompt, max_new_tokens=2) for r in reqs])
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _, logits = eng.generate(reqs, return_logits=True)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    others = {k: v for k, v in launches.items() if k != kernel}
    if launches[kernel] != cfg.n_layers or any(others.values()):
        raise AssertionError(f"{arch} serve launches {launches}, expected "
                             f"{cfg.n_layers} of {kernel} and no other")
    out = np.stack([r.out for r in reqs])
    if (out.shape != (B, new) or not np.isfinite(logits).all()
            or not ((out >= 0) & (out < cfg.vocab)).all()
            or not np.array_equal(out[:, 0], logits[0].argmax(-1))):
        raise AssertionError(f"{arch} serve: tokens {out.shape} or logits "
                             "not finite")
    prompts = np.stack([r.prompt for r in reqs])
    batch = {"tokens": torch.tensor(prompts, device=dev)}
    first = torch.tensor(out[:, :1], device=dev)
    err = {"bfloat16": decode_vs_forward(cfg, eng.params, batch, first,
                                         logits[1]),
           "float32": decode_vs_forward(
               configs.override(cfg, dtype="float32"), eng.params, batch,
               first)}
    for dt, e in err.items():
        if not e <= DECODE_TOL[arch][layers.dtype_of(dt)]:
            raise AssertionError(f"{arch} ({dt}): decode logits at position "
                                 f"{S} vs forward: relative error {e:.3e}")
    st = eng.stats
    prof = serve_profiles(cfg, eng.params, prompts, dev)
    emit({"phase": f"serve_{arch}", "batch": B, "prompt_len": S,
          "new_tokens": new, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab, "dtype": cfg.dtype,
          "params": sum(t.numel() for t in _leaves(eng.params)),
          "prefill_ms": st["prefill_ms"],
          "decode_ms_per_token": st["decode_ms"] / new,
          "decode_tokens_per_s": B * new / (st["decode_ms"] / 1e3),
          "wall_s": wall, "peak_allocated_gb": peak / 1e9,
          "launches": launches, "launcher_launches": via_cli,
          "decode_vs_forward_rel_err": err,
          "profile": prof})
    return launches


def serve_profiles(cfg, params, prompts, dev, steps=8):
    """One prefill and ``steps`` decode steps under the profiler."""
    toks = torch.tensor(prompts, device=dev)
    nxt = toks[:, -1:].contiguous()
    max_len = prompts.shape[1] + steps
    with torch.inference_mode():
        pre = profiled(lambda: lm.prefill(cfg, params, {"tokens": toks},
                                          max_len))
        _, cache = lm.prefill(cfg, params, {"tokens": toks}, max_len)

        def decode():
            c = cache
            for _ in range(steps):
                c = lm.decode_step(cfg, params, c, {"tokens": nxt})[1]
        dec = profiled(decode)
    return {"prefill": pre, f"decode_{steps}_steps": dec}


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def phase_card_vs_cpu(dev):
    """Both archs at full width and 2 layers in float32, the same weights on
    the card and on the CPU (module docstring, phase 7c): prefill logits,
    every cache leaf, and the logits of teacher-forced decode steps, each
    relative to its largest |value| (logits: the largest |logit|)."""
    c = CARD_VS_CPU
    B, S, steps = c["B"], c["S"], c["steps"]
    worst = {}
    _build.reset_launches()
    for arch in SERVE:
        cfg = launcher.serve_config(arch, n_layers=c["layers"],
                                      dtype="float32")
        p_card = lm.init_params(cfg, 2, dev)
        rng = np.random.default_rng(3)
        toks = rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int32)
        forced = rng.integers(0, cfg.vocab, size=(B, steps), dtype=np.int32)
        got = {}
        for d, p in ((dev, p_card), ("cpu", lm.tree_to(p_card, "cpu"))):
            with torch.inference_mode():
                logits, cache = lm.prefill(
                    cfg, p, {"tokens": torch.tensor(toks, device=d)},
                    S + steps)
            eng = Engine(cfg, p, max_len=S + steps, device=d)
            _, lg = eng.generate([Request(prompt=t, max_new_tokens=steps)
                                  for t in toks], forced=forced,
                                 return_logits=True)
            got[d] = (logits.cpu().numpy(),
                      {k: v.float().cpu().numpy() for k, v in cache.items()},
                      lg)
        (l_a, c_a, g_a), (l_b, c_b, g_b) = got[dev], got["cpu"]
        scale = float(np.abs(l_b).max())
        errs = {"prefill_logits": float(np.abs(l_a - l_b).max()) / scale,
                "decode_logits": float(np.abs(g_a - g_b).max()
                                       / np.abs(g_b).max())}
        for k in c_b:
            errs[f"cache.{k}"] = float(np.abs(c_a[k] - c_b[k]).max()
                                       / max(np.abs(c_b[k]).max(), 1e-30))
        worst[arch] = errs
    launches = dict(_build.LAUNCHES)
    emit({"phase": "serve_card_vs_cpu", **c, "errs": worst,
          "launches": launches})
    bad = {a: {k: v for k, v in e.items() if not v <= c["tol"]}
           for a, e in worst.items()}
    if any(bad.values()):
        raise AssertionError(f"card vs CPU errors above {c['tol']}: {bad}")
    # two prefills per arch on the card: lm.prefill and Engine.generate's
    if (launches["flash_attention"] != 2 * c["layers"]
            or launches["wkv6_forward"] != 2 * c["layers"]):
        raise AssertionError(f"card vs CPU launches {launches}")
    return launches


def phase_nn_fitness(dev):
    """``run_ipop`` over ``make_nn_fitness`` on qwen2-0.5b at full width
    (module docstring, phase 8).  Returns the launches and the widest
    shape of the sample kernel (row 1)."""
    cfg = launcher.serve_config(NN["arch"])
    data = SyntheticTokens(cfg, seq_len=NN["S"], global_batch=NN["B"], seed=1)
    fitness, space = make_nn_fitness(cfg, lm.init_params(cfg, 3, dev),
                                     data.batch_at(999), device=dev)
    evaluated = [0]

    def counted(X):
        evaluated[0] += X.shape[0]
        return fitness(X)
    base = float(fitness(torch.zeros((1, space.dim), dtype=torch.float64,
                                     device=dev))[0])
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = ipop.run_ipop(counted, space.dim, 21, lam_start=NN["lam_start"],
                        kmax_exp=NN["kmax_exp"], max_evals=NN["max_evals"],
                        backend="bucketed", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    steps = sum(sg["gens"] for sg in res.driver["segments"])
    rows = evaluated[0]
    useful = sum(len(d.gens) * d.lam for d in res.descents)
    lam_last = res.descents[-1].lam
    if launches["flash_attention"] != cfg.n_layers * rows:
        raise AssertionError(f"nn fitness: {launches['flash_attention']} "
                             f"flash launches for {rows} evaluated rows")
    if (launches["cma_gen_sample"] != steps
            or launches["cma_gen_update"] != steps):
        raise AssertionError(f"nn fitness launches {launches} for {steps} "
                             "generations")
    if not (res.total_fevals == useful <= NN["max_evals"]
            and NN["max_evals"] - res.total_fevals < lam_last
            and np.isfinite(res.best_f) and np.isfinite(base)):
        raise AssertionError(f"nn fitness: fevals {res.total_fevals}, "
                             f"useful {useful}, best {res.best_f}")
    emit({"phase": "nn_fitness_qwen2", "n": space.dim, **NN,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "ms_per_eval": wall / rows * 1e3,
          "ms_per_useful_eval": wall / res.total_fevals * 1e3,
          "wall_s": wall, "baseline_ce": base, "best_ce": res.best_f,
          "fevals": res.total_fevals, "rows_evaluated": rows,
          "steps": steps, "segments": len(res.driver["segments"]),
          "descents": [[d.lam, len(d.gens), d.stop_reason]
                       for d in res.descents], "launches": launches,
          "profile_4_evals": profiled(lambda: fitness(
              torch.zeros((4, space.dim), dtype=torch.float64,
                          device=dev)))})
    return launches, dict(S=1, lam=max(d.lam for d in res.descents),
                          n=space.dim)


# ---------------------------------------------------------------------------
# phases 13a-13d: the dense descent and training
# ---------------------------------------------------------------------------

def default_lam(n: int) -> int:
    """Hansen's default population, 4 + ⌊3 ln n⌋."""
    return 4 + int(3 * np.log(n))


def phase_descent(dev):
    """``cmaes.run`` on the card (module docstring, phase 13a): f8 at
    n = 1000, default λ, 32 generations (rows 1 and 6 once a generation);
    then f1 at n = 8, λ = 16, card against CPU.  Returns the n = 1000
    run's launches and the card-vs-CPU run's."""
    from repro_torch.core import stopping
    c, sm = DESCENT, DESCENT_SMALL
    n, lam = c["n"], default_lam(c["n"])
    cfg = CMAConfig(n=n, lam=lam)
    fn, inst = bbob.make_fitness(c["fid"], n, 1, device=dev)
    x0 = torch.zeros(n, dtype=torch.float64)
    cmaes.run(cfg, make_params(cfg), fn, 1, x0, 2.0, max_gens=2,
              device=dev)                                   # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    st = cmaes.run(cfg, make_params(cfg), fn, 7, x0, 2.0,
                   max_gens=c["gens"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    gens = int(st.gen)
    if not (gens == c["gens"] and launches["cma_gen_sample"] == gens
            and launches["cma_gen_update"] == gens
            and sum(launches.values()) == 2 * gens
            and int(st.fevals) == gens * lam
            and np.isfinite(float(st.best_f))):
        raise AssertionError(f"descent n={n}: {gens} generations, fevals "
                             f"{int(st.fevals)}, launches {launches}")
    # card against CPU
    cfg8 = CMAConfig(n=sm["n"], lam=sm["lam"])
    x8 = np.linspace(-2.0, 2.0, sm["n"])
    runs = []
    for d in (dev, torch.device("cpu")):
        f8, i8 = bbob.make_fitness(sm["fid"], sm["n"], 1, device=d)
        _build.reset_launches()
        runs.append((cmaes.run(cfg8, make_params(cfg8), f8, 11, x8, 1.0,
                               device=d), dict(_build.LAUNCHES)))
    (card, l8), (cpu, _) = runs
    ints = {f: (int(getattr(card, f)), int(getattr(cpu, f)))
            for f in ("gen", "fevals", "stop_reason", "last_eigen_gen",
                      "hist_count")}
    err, _ = f_err(float(card.best_f), float(cpu.best_f), float(i8.f_opt))
    if (any(a != b for a, b in ints.values()) or not err <= sm["tol"]
            or not bool(card.stop)
            or l8["cma_gen_sample"] != ints["gen"][0]
            or l8["cma_gen_update"] != ints["gen"][0]):
        raise AssertionError(f"descent card vs CPU: ints {ints}, best err "
                             f"{err}, launches {l8}")
    emit({"phase": "descent", "n": n, "lam": lam, "fid": c["fid"],
          "gens": gens, "ms_per_gen": wall / gens * 1e3,
          "best_minus_fopt": float(st.best_f) - float(inst.f_opt),
          "launches": launches,
          "card_vs_cpu": {**sm, "ints": ints, "best_err": err,
                          "stop": stopping.reason_to_str(
                              ints["stop_reason"][0]),
                          "launches": l8}})
    return launches, l8


def _trainer(cfg, c, ckpt_dir, steps, ckpt_every, dev):
    from repro_torch.train import optimizer, train_step, trainer
    tc = trainer.TrainerConfig(
        total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(ckpt_dir),
        log_every=1, train=train_step.TrainConfig(
            adamw=optimizer.AdamWConfig(lr=c["lr"], warmup_steps=c["warmup"],
                                        total_steps=c["steps"])))
    return trainer.Trainer(cfg, tc, seq_len=c["S"], global_batch=c["B"],
                           log_fn=lambda _m: None, device=dev)


def train_run(cfg, c, ckpt_dir, dev, steps=None, ckpt_every=None,
              keep=False):
    """A ``Trainer.run`` (resuming from ``ckpt_dir`` if it holds a step):
    (trainer, its final (params, opt) if ``keep``, wall s, launches, peak
    GB, each step's wall s, the step ending in a synchronize)."""
    t = _trainer(cfg, c, ckpt_dir, steps or c["steps"],
                 ckpt_every or c.get("ckpt_every", 10 ** 6), dev)
    stamps, inner = [], t.step_fn

    def timed(*args):
        t0 = time.perf_counter()
        out = inner(*args)
        float(out[2]["loss"])
        stamps.append(time.perf_counter() - t0)
        return out
    t.step_fn = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = t.run(resume=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (t, out if keep else None, wall, dict(_build.LAUNCHES),
            torch.cuda.max_memory_allocated() / 1e9, stamps)


def _losses(t):
    return [h["loss"] for h in t.history]


def leaves_equal(a, b) -> bool:
    """Two tensor trees bit for bit (dtype, shape and values)."""
    la, lb = sharding.leaves(a), sharding.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def phase_train_qwen2(dev):
    """``Trainer.run`` on qwen2-0.5b at full width and depth (module
    docstring, phase 13b), then the resume check.  Returns the
    uninterrupted run's launches."""
    c = TRAIN
    cfg = configs.override(configs.get_config(c["arch"]), attn_impl="flash",
                           remat=False)
    root = Path(tempfile.mkdtemp(prefix="chip_train_"))
    try:
        t, _, wall, launches, peak, stamps = train_run(cfg, c, root / "a",
                                                       dev)
        losses = _losses(t)
        n = c["steps"]
        if not (len(losses) == n and all(np.isfinite(losses))
                and np.mean(losses[-2:]) < np.mean(losses[:2])):
            raise AssertionError(f"qwen2 training losses {losses}")
        want = cfg.n_layers * n
        if (launches["flash_attention"] != want
                or launches["flash_attention_bwd"] != want):
            raise AssertionError(f"qwen2 training: {launches} for {n} steps "
                                 f"of {cfg.n_layers} layers")
        # a run that stops after its step-3 checkpoint, then the restart
        cut = c["ckpt_every"]
        tb, saved, *_ = train_run(cfg, c, root / "b", dev, steps=cut,
                                  keep=True)
        tr = _trainer(cfg, c, root / "b", c["steps"], c["ckpt_every"], dev)
        plain_restore, checked = tr.try_restore, []

        def restore_and_check(params, opt):
            rp, ro, rstep = plain_restore(params, opt)
            pb, ob = saved
            checked.append(rstep == cut and leaves_equal(rp, pb)
                           and leaves_equal((ro.mu, ro.nu, ro.step),
                                            (ob.mu, ob.nu, ob.step)))
            saved.clear()
            return rp, ro, rstep
        saved = list(saved)
        tr.try_restore = restore_and_check
        tr.run(resume=True)
        bit_equal = checked == [True]
        resumed = _losses(tr)
        rel = [abs(a - b) / abs(b) for a, b in zip(resumed, losses[cut:])]
        first = [abs(a - b) / abs(b) for a, b in zip(_losses(tb),
                                                     losses[:cut])]
        if not (bit_equal and len(resumed) == n - cut
                and max(rel + first) <= RESUME_TOL):
            raise AssertionError(f"qwen2 resume: restored bit-equal "
                                 f"{bit_equal}, losses {resumed} against "
                                 f"{losses[cut:]} (rel {rel}, first {first})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    step_s = float(np.mean(stamps[1:]))
    emit({"phase": "train_qwen2", **c, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "remat": cfg.remat,
          "losses": losses, "resumed_losses": resumed,
          "resume_rel_err": max(rel), "restart_first_rel_err": max(first),
          "restored_bit_equal": bit_equal, "step_s": stamps,
          "ms_per_step": step_s * 1e3,
          "tokens_per_s": c["B"] * c["S"] / step_s,
          "wall_s": wall, "peak_gb": peak, "launches": launches})
    return launches


def phase_train_rwkv6(dev):
    """``Trainer.run`` on rwkv6-3b at full width, 4 layers, remat on
    (module docstring, phase 13c).  Returns its launches."""
    c = TRAIN_RWKV
    cfg = configs.override(configs.get_config(c["arch"]),
                           n_layers=c["layers"])
    root = Path(tempfile.mkdtemp(prefix="chip_train_"))
    try:
        t, _, wall, launches, peak, stamps = train_run(cfg, c, root / "a",
                                                       dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = _losses(t)
    n = c["steps"]
    if not (len(losses) == n and all(np.isfinite(losses))):
        raise AssertionError(f"rwkv6 training losses {losses}")
    # remat: the forward kernel runs again in each layer's backward
    if (launches["wkv6_backward"] != cfg.n_layers * n
            or launches["wkv6_forward"] != 2 * cfg.n_layers * n):
        raise AssertionError(f"rwkv6 training: {launches} for {n} steps of "
                             f"{cfg.n_layers} layers")
    step_s = float(np.mean(stamps[1:]))
    emit({"phase": "train_rwkv6", **c, "d_model": cfg.d_model,
          "remat": cfg.remat, "losses": losses, "step_s": stamps,
          "ms_per_step": step_s * 1e3,
          "tokens_per_s": c["B"] * c["S"] / step_s, "wall_s": wall,
          "peak_gb": peak, "launches": launches})
    return launches


def phase_train_card_vs_cpu(dev):
    """One ``make_train_step`` step of each smoke config (head dims 32) in
    float32 on the card and on the CPU from the same weights (module
    docstring, phase 13d).  Returns the card's launches."""
    from repro_torch.train import optimizer, train_step
    c = TRAIN_CPU
    out, all_launches = {}, {}
    for arch in SERVE:
        cfg = configs.override(configs.smoke_config(arch), dtype="float32",
                               attn_impl="flash", remat=False,
                               head_dim=c["head_dim"],
                               rwkv_head_dim=c["head_dim"])
        p_card = lm.init_params(cfg, 5, dev)
        batch = SyntheticTokens(cfg, seq_len=c["S"], global_batch=c["B"],
                                seed=2).batch_at(0)
        step = train_step.make_train_step(cfg, train_step.TrainConfig(
            adamw=optimizer.AdamWConfig(lr=3e-3, warmup_steps=1)))
        got = {}
        for d, p in ((dev, p_card), ("cpu", lm.tree_to(p_card, "cpu"))):
            b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(d)
                 for k, v in batch.items()}
            _build.reset_launches()
            grads, loss, _ = train_step.grads_and_loss(cfg, p, b)
            _, _, m = step(p, optimizer.init_opt_state(p), b)
            got[str(d)] = (float(loss), float(m["loss"]),
                           lm.tree_to(grads, "cpu"), dict(_build.LAUNCHES))
        (l_a, m_a, g_a, launches), (l_b, m_b, g_b, _) = (
            got[str(dev)], got["cpu"])
        worst = 0.0
        for x, y in zip(sharding.leaves(g_a), sharding.leaves(g_b)):
            worst = max(worst, float((x - y).abs().max())
                        / max(float(y.abs().max()), 1e-30))
        loss_err = max(abs(l_a - l_b), abs(m_a - m_b)) / abs(l_b)
        kernel = SERVE[arch]["kernel"]
        bwd = {"flash_attention": "flash_attention_bwd",
               "wkv6_forward": "wkv6_backward"}[kernel]
        # grads_and_loss and the step: one forward and backward each
        if (loss_err > c["loss_tol"] or worst > TRAIN_CPU_TOL
                or launches[kernel] != 2 * cfg.n_layers
                or launches[bwd] != 2 * cfg.n_layers):
            raise AssertionError(f"train card vs CPU {arch}: loss err "
                                 f"{loss_err}, grad err {worst}, launches "
                                 f"{launches}")
        out[arch] = {"loss": l_b, "loss_rel_err": loss_err,
                     "grad_max_rel_err": worst, "launches": launches}
        for k, v in launches.items():
            all_launches[k] = all_launches.get(k, 0) + v
    emit({"phase": "train_card_vs_cpu", **c, "grad_tol": TRAIN_CPU_TOL,
          "archs": out})
    return all_launches


# ---------------------------------------------------------------------------
# phases 14a-14f: the other LM families
# ---------------------------------------------------------------------------

def flash_layers(cfg) -> int:
    """The causal self-attention layers of ``cfg``: one flash launch each a
    prefill (cross-attention layers take the plain chunked path)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return lm.zamba_units(cfg)[0]
    if cfg.family == "vlm":
        n_units, n_self = lm.vlm_units(cfg)
        return n_units * n_self
    return cfg.n_layers


def family_inputs(cfg, B, S, rng, dev):
    """A prefill batch on ``dev``: tokens (or stub frames) and, for vlm,
    stub image embeddings, standard normal."""
    batch = {}
    if cfg.embed_inputs:
        batch["tokens"] = torch.tensor(
            rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int32),
            device=dev)
    else:
        batch["frames"] = torch.tensor(
            rng.standard_normal((B, S, cfg.d_model), dtype=np.float32),
            device=dev)
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.tensor(
            rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model),
                                dtype=np.float32), device=dev)
    return batch


def step_key(cfg) -> str:
    return "tokens" if cfg.embed_inputs else "frames"


def decode_vs_forward(cfg, params, batch, step, got=None):
    """The logits of the decode step that takes ``step`` (the next token or
    frame) after the prefill of ``batch`` — ``got``, or computed here —
    against ``lm.forward``'s last logits over the batch and ``step``: max
    |difference| over the largest |logit|."""
    key = step_key(cfg)
    S = batch[key].shape[1]
    with torch.inference_mode():
        if got is None:
            _, cache = lm.prefill(cfg, params, batch, S + 1)
            got = lm.decode_step(cfg, params, cache,
                                 {key: step})[0].cpu().numpy()
        full = dict(batch, **{key: torch.cat([batch[key], step], dim=1)})
        hidden, _ = lm.forward(cfg, params, full)
        want = lm.logits_last(cfg, params, hidden).cpu().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


@contextlib.contextmanager
def flash_windows(tally):
    """Count the flash launches by window into ``tally`` (gemma's local and
    global layers), through the wrapper that ``ops`` calls."""
    real = flash_attention.flash_attention

    def counted(q, k, v, *, causal=True, window=0):
        tally[window] = tally.get(window, 0) + 1
        return real(q, k, v, causal=causal, window=window)
    flash_attention.flash_attention = counted
    try:
        yield
    finally:
        flash_attention.flash_attention = real


def flash_only(name, launches, want):
    """``want`` flash launches and no other kernel, or raise."""
    others = {k: v for k, v in launches.items() if k != "flash_attention"}
    if launches["flash_attention"] != want or any(others.values()):
        raise AssertionError(f"{name}: launches {launches}, expected {want} "
                             "of flash_attention and no other")


def family_generate(cfg, params, batch, new, dev):
    """``lm.prefill`` and ``new`` decode steps (greedy tokens, or stub
    frames), timed with CUDA events: (prefill ms, decode ms, first decode
    step's logits, its input)."""
    key = step_key(cfg)
    B, S = batch[key].shape[:2]
    if cfg.embed_inputs:
        frames = None
    else:
        frames = torch.randn((new, B, 1, cfg.d_model), device=dev,
                             generator=torch.Generator(dev).manual_seed(2))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with torch.inference_mode():
        ev[0].record()
        logits, cache = lm.prefill(cfg, params, batch, S + new)
        ev[1].record()
        first_logits, first = None, None
        for t in range(new):
            nxt = (torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                   if frames is None else frames[t])
            logits, cache = lm.decode_step(cfg, params, cache, {key: nxt})
            if t == 0:
                first_logits, first = logits, nxt
        ev[2].record()
    torch.cuda.synchronize()
    return (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
            first_logits.cpu().numpy(), first)


def phase_serve_family(dev, arch):
    """An arch of ``FAMILIES`` served at its published width (module
    docstring, phases 14a-14e).  Returns its launches (gemma: by window,
    as its local and global paths)."""
    f = FAMILIES[arch]
    B, S, new = f["B"], f["S"], f["new"]
    kw = {"n_layers": f["layers"]} if f["layers"] else {}
    if "param_dtype" in f:
        kw["param_dtype"] = f["param_dtype"]
    cfg = launcher.serve_config(arch, **kw)
    if flash_layers(cfg) != f["flash"]:
        raise AssertionError(f"{arch}: {flash_layers(cfg)} flash layers")
    torch.cuda.reset_peak_memory_stats(dev)
    via_cli = None
    if f["engine"] and not f["layers"]:
        _build.reset_launches()
        launcher.main(["--arch", arch])
        torch.cuda.synchronize()
        via_cli = dict(_build.LAUNCHES)
        torch.cuda.empty_cache()
        flash_only(f"{arch} launcher", via_cli, f["flash"])
    params = lm.init_params(cfg, 0, dev)
    rng = np.random.default_rng(1)
    batch = family_inputs(cfg, B, S, rng, dev)
    windows = {}
    if f["engine"]:
        eng = Engine(cfg, params, max_len=S + new, device=dev)
        prompts = batch["tokens"].cpu().numpy()
        reqs = [Request(prompt=p, max_new_tokens=new) for p in prompts]
        # warm-up at the same shapes (cuBLAS picks its kernels on first use)
        eng.generate([Request(prompt=p, max_new_tokens=2) for p in prompts])
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        with flash_windows(windows):
            _, logits = eng.generate(reqs, return_logits=True)
        wall = time.perf_counter() - t0
        out = np.stack([r.out for r in reqs])
        if (out.shape != (B, new) or not np.isfinite(logits).all()
                or not ((out >= 0) & (out < cfg.vocab)).all()
                or not np.array_equal(out[:, 0], logits[0].argmax(-1))):
            raise AssertionError(f"{arch} serve: tokens {out.shape} or "
                                 "logits not finite")
        prefill_ms = eng.stats["prefill_ms"]
        decode_ms = eng.stats["decode_ms"]
        got, first = logits[1], torch.tensor(out[:, :1], device=dev)
    else:
        family_generate(cfg, params, batch, 2, dev)            # warm-up
        _build.reset_launches()
        t0 = time.perf_counter()
        with flash_windows(windows):
            prefill_ms, decode_ms, got, first = family_generate(
                cfg, params, batch, new, dev)
        wall = time.perf_counter() - t0
        if not np.isfinite(got).all():
            raise AssertionError(f"{arch}: decode logits not finite")
    launches = dict(_build.LAUNCHES)
    flash_only(f"{arch} serve", launches, f["flash"])
    # a decode step's logits against a full forward, bf16 and f32; MoE at
    # a capacity where nothing drops
    moe = cfg.family == "moe"
    exact = ({"capacity_factor": cfg.n_experts / cfg.experts_per_tok}
             if moe else {})
    err = {}
    for dt in ("bfloat16", "float32"):
        c = configs.override(cfg, dtype=dt, **exact)
        reuse = got if (dt == cfg.dtype and not moe) else None
        err[dt] = decode_vs_forward(c, params, batch, first, reuse)
        tol = DECODE_TOL[arch][layers.dtype_of(dt)]
        if tol is not None and not err[dt] <= tol:
            raise AssertionError(f"{arch} ({dt}): decode logits at position "
                                 f"{S} vs forward: relative error "
                                 f"{err[dt]:.3e} > {tol:.0e}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    if not peak < FAMILY_PEAK_GB:
        raise AssertionError(f"{arch}: peak {peak:.2f} GB, above 13b's "
                             f"{FAMILY_PEAK_GB} GB")
    emit({"phase": f["tag"], "arch": arch, "batch": B, "prompt_len": S,
          "new_tokens": new, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "head_dim": cfg.head_dim,
          "vocab": cfg.vocab, "dtype": cfg.dtype,
          "param_dtype": cfg.param_dtype,
          "params": sum(t.numel() for t in _leaves(params)),
          "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms / new,
          "decode_tokens_per_s": B * new / (decode_ms / 1e3),
          "wall_s": wall, "peak_allocated_gb": peak,
          "launches": launches, "launcher_launches": via_cli,
          "flash_by_window": windows,
          "decode_vs_forward_rel_err": err,
          "decode_tol": {str(k): v for k, v in DECODE_TOL[arch].items()},
          **({"moe_capacity_factor_compared": exact["capacity_factor"]}
             if moe else {})})
    if arch == "gemma3-4b":
        w = cfg.sliding_window
        if sorted(windows) != [0, w] or sum(windows.values()) != f["flash"]:
            raise AssertionError(f"gemma3-4b flash by window {windows}")
        return {"local": dict(launches, flash_attention=windows[w]),
                "global": dict(launches, flash_attention=windows[0])}
    return launches


def phase_families_card_vs_cpu(dev):
    """The configs of ``FAMILIES_CPU`` at their smoke cuts with head dims
    32, in float32, the same weights on the card and on the CPU (module
    docstring, phase 14f): prefill logits, every cache leaf and
    teacher-forced decode logits, each within ``tol`` of its largest
    |value|; one flash launch a causal self-attention layer of the card's
    prefill and no other kernel.  Returns the card's launches."""
    c = FAMILIES_CPU
    B, S, steps = c["B"], c["S"], c["steps"]
    worst, total = {}, None
    for arch in c["archs"]:
        kw = dict(dtype="float32", head_dim=c["head_dim"])
        if arch in c["layers"]:
            kw["n_layers"] = c["layers"][arch]
        cfg = launcher.serve_config(arch, smoke=True, **kw)
        p_card = lm.init_params(cfg, 4, dev)
        rng = np.random.default_rng(5)
        batch = family_inputs(cfg, B, S, rng, "cpu")
        key = step_key(cfg)
        if cfg.embed_inputs:
            forced = torch.tensor(rng.integers(
                0, cfg.vocab, size=(steps, B, 1), dtype=np.int32))
        else:
            forced = torch.tensor(rng.standard_normal(
                (steps, B, 1, cfg.d_model), dtype=np.float32))
        got = {}
        for d, p in ((dev, p_card), ("cpu", lm.tree_to(p_card, "cpu"))):
            _build.reset_launches()
            with torch.inference_mode():
                logits, cache = lm.prefill(
                    cfg, p, {k: v.to(d) for k, v in batch.items()},
                    S + steps)
                launches = dict(_build.LAUNCHES)
                # copies: decode writes the cache in place (on the CPU a
                # tensor's numpy view would follow it)
                first = {k: v.float().cpu().numpy().copy()
                         for k, v in cache.items()}
                lg = []
                for t in range(steps):
                    out, cache = lm.decode_step(cfg, p, cache,
                                                {key: forced[t].to(d)})
                    lg.append(out.cpu().numpy())
            got[str(d)] = (logits.cpu().numpy(), first, np.stack(lg),
                           launches)
        (l_a, c_a, g_a, launches), (l_b, c_b, g_b, _) = (got[str(dev)],
                                                         got["cpu"])
        flash_only(f"{arch} card vs CPU prefill", launches,
                   flash_layers(cfg))
        errs = {"prefill_logits": float(np.abs(l_a - l_b).max()
                                        / np.abs(l_b).max()),
                "decode_logits": float(np.abs(g_a - g_b).max()
                                       / np.abs(g_b).max())}
        for k in c_b:
            errs[f"cache.{k}"] = float(np.abs(c_a[k] - c_b[k]).max()
                                       / max(np.abs(c_b[k]).max(), 1e-30))
        worst[arch] = errs
        total = launches if total is None else {
            k: total[k] + v for k, v in launches.items()}
    emit({"phase": "families_card_vs_cpu", **c, "errs": worst,
          "launches": total})
    bad = {a: {k: v for k, v in e.items() if not v <= c["tol"]}
           for a, e in worst.items()}
    if any(bad.values()):
        raise AssertionError(f"families card vs CPU errors above "
                             f"{c['tol']}: {bad}")
    return total


def lm_bound(flops, nbytes, dtype):
    t_ops = flops / LM_PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def _sdpa(q, k, v, window=0):
    """One PyTorch call of the same attention on (B, H, S, D) tensors made
    contiguous beforehand: the yardstick, used nowhere in the port.  With
    a window, an explicit boolean mask (keys j with i − window < j ≤ i)."""
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window <= 0:
        return lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    i = torch.arange(q.shape[1], device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    return lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def causal_pairs(S: int, window: int = 0) -> int:
    """The (query, key) pairs a causal mask (and a window) keeps."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def lm_kernel_rows(dev, errs, launches):
    """Rows 9 and 10 of the ``kernels`` line: per path its launches and, at
    that path's shape and dtype, the kernel's, the plain version's and (row
    9) SDPA's times and the bound."""
    def flash_work(B, S, H, Hk, D, dtype, window=0):
        q, k, v = flash_inputs(B, S, H, Hk, D, dtype, dev)
        pairs = causal_pairs(S, window)            # unmasked (q, k)
        b_ms, b_by = lm_bound(4.0 * B * H * pairs * D,
                              q.element_size() * 2 * B * S * D * (H + Hk),
                              dtype)
        kw = dict(causal=True, window=window)
        return {"shape": [B, S, H, Hk, D], "window": window,
                "dtype": str(dtype),
                "ms": time_ms(lambda: flash_attention.flash_attention(
                    q, k, v, **kw)),
                "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v,
                                                                **kw)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(_sdpa(q, k, v, window))}

    def wkv_work(B, S, H, D, dtype):
        a = wkv_inputs(B, S, H, D, dtype, dev)
        args = [a[k] for k in ("r", "k", "v", "logw", "u", "state")]
        n = B * S * H * D
        nbytes = (a["r"].element_size() * 4 * n + 4 * n + 4 * H * D
                  + 2 * 4 * B * H * D * D)
        flops = B * H * S * (2.0 * 16 * D + 4.0 * D * D)
        # the kernel computes in f32 whatever its inputs' type: its
        # operations go at the f32 FMA rate
        b_ms, b_by = lm_bound(flops, nbytes, torch.float32)

        def kern():
            return rwkv6_wkv.wkv6_forward(*args)
        return {"shape": [B, S, H, D], "dtype": str(dtype),
                "ms": time_ms(kern),
                "plain_ms": time_ms(lambda: ref.wkv_chunked(*args), reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,
                "profile": profile_update.profile_call(kern, 20)}

    q2 = configs.get_config("qwen2-0.5b")
    rw = configs.get_config("rwkv6-3b")
    qh = (q2.n_heads, q2.n_kv_heads, q2.head_dim)
    rh = (rw.d_model // rw.rwkv_head_dim, rw.rwkv_head_dim)
    c = CARD_VS_CPU
    s_pad = -(-c["S"] // ref.WKV_CHUNK) * ref.WKV_CHUNK
    bf16, f32 = torch.bfloat16, torch.float32
    work = {
        "flash_attention": {
            "serve_qwen2": flash_work(SERVE["qwen2-0.5b"]["B"],
                                      SERVE["qwen2-0.5b"]["S"], *qh, bf16),
            "nn_fitness_qwen2": flash_work(NN["B"], NN["S"], *qh, bf16),
            "serve_card_vs_cpu": flash_work(c["B"], c["S"], *qh, f32),
            "train_qwen2": flash_work(TRAIN["B"], TRAIN["S"], *qh, bf16),
            # the other families (14a-14f)
            **{p: flash_work(*(c[k] for k in ("B", "S", "H", "Hk", "D")),
                             bf16, window=c["window"])
               for p, c in family_flash_shapes().items()},
            # 14f: gemma3-4b's smoke local layer (head dim 32), float32
            "families_card_vs_cpu": flash_work(
                FAMILIES_CPU["B"], FAMILIES_CPU["S"], 4, 2,
                FAMILIES_CPU["head_dim"], f32,
                window=configs.smoke_config("gemma3-4b").sliding_window),
            # phi3-mini's prefill shape, which phase 2 checks and no path
            # runs (launches null)
            UNDRIVEN: flash_work(1, 512, 32, 32, 96, bf16)},
        "wkv6_forward": {
            "serve_rwkv6": wkv_work(SERVE["rwkv6-3b"]["B"],
                                    SERVE["rwkv6-3b"]["S"], *rh, bf16),
            "serve_card_vs_cpu": wkv_work(c["B"], s_pad, *rh, f32),
            "train_rwkv6": wkv_work(TRAIN_RWKV["B"], TRAIN_RWKV["S"], *rh,
                                    bf16)}}
    rows = []
    for name, paths in work.items():
        for p, w in paths.items():
            w["launches"] = None if p == UNDRIVEN else launches[p][name]
        top = paths["serve_qwen2" if name == "flash_attention"
                    else "serve_rwkv6"]
        rows.append({"name": name, "route": "cuda",
                     "source": SOURCES[name][0], "replaces": SOURCES[name][1],
                     "launches": sum(launches[p][name] for p in launches),
                     "max_abs_err": errs[name],
                     **{k: top[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")},
                     "paths": paths})
    return rows


def median_ms(fn, windows=20, per_window=5) -> float:
    """Median over ``windows`` windows of the mean ms of ``per_window``
    launches each, after a warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(windows):
        start.record()
        for _ in range(per_window):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_window)
    return float(np.median(times))


def sdpa_bwd_library(q, k, v, do):
    """Row 11's yardstick on (B, H, S, D) tensors (q, k, v requiring grad):
    the autograd backward of one causal SDPA call, timed by ``median_ms``,
    with ``enable_gqa`` on the backend PyTorch picks (named, from
    ``torch._fused_sdp_choice``), and, for fp16 and bf16 inputs, with the
    flash backend forced over K and V expanded to the query heads outside
    the timed call (its dK and dV are then per query head, not summed over
    the group); ``ms`` is the faster.  Used nowhere in the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        picked = SDPBackend(torch._fused_sdp_choice(
            q, k, v, is_causal=True, enable_gqa=True)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        picked = f"unknown ({type(e).__name__})"
    out = sdpa(q, k, v, is_causal=True, enable_gqa=True)
    gqa_ms = median_ms(lambda: torch.autograd.grad(out, (q, k, v), do,
                                                   retain_graph=True))
    if q.dtype not in (torch.float16, torch.bfloat16):
        return {"backend": picked, "gqa_ms": gqa_ms, "flash_ms": None,
                "flash": "the flash backend takes fp16 and bf16 only",
                "ms": gqa_ms}
    rep = q.shape[1] // k.shape[1]
    ke, ve = (x.detach().repeat_interleave(rep, dim=1).requires_grad_()
              for x in (k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        out_f = sdpa(q, ke, ve, is_causal=True)
    flash_ms = median_ms(lambda: torch.autograd.grad(out_f, (q, ke, ve), do,
                                                     retain_graph=True))
    return {"backend": picked, "gqa_ms": gqa_ms, "flash_ms": flash_ms,
            "ms": min(gqa_ms, flash_ms)}


def train_kernel_rows(dev, errs, launches):
    """Rows 11 and 12 of the ``kernels`` line: per training path its
    launches and, at the path's shape and dtype, the backward kernel's,
    the plain version's and (row 11) the autograd backward of one SDPA
    call's times (``sdpa_bwd_library``), and the bound (module docstring,
    phase 5)."""
    def flash_bwd_work(B, S, H, Hk, D, dtype):
        q, k, v = flash_inputs(B, S, H, Hk, D, dtype, dev)
        do = flash_inputs(B, S, H, 1, D, dtype, dev, seed=1)[0]
        o, lse = flash_attention.flash_attention_stats(q, k, v)
        pairs = S * (S + 1) // 2                   # unmasked (q, k), causal
        # s, dp, dq, dk and dv: 10 D operations an unmasked pair; q, o,
        # do, dq (B S H D), k, v, dk, dv (B S Hk D) and lse (B S H, f32)
        b_ms, b_by = lm_bound(10.0 * B * H * pairs * D,
                              q.element_size() * B * S * D * (4 * H + 4 * Hk)
                              + 4 * B * S * H, dtype)
        qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_()
                      for a in (q, k, v))
        library = sdpa_bwd_library(qt, kt, vt,
                                   do.transpose(1, 2).contiguous())

        def kern():
            return flash_attention.flash_attention_bwd(q, k, v, o, lse, do)
        return {"shape": [B, S, H, Hk, D], "dtype": str(dtype),
                "ms": time_ms(kern),
                "plain_ms": time_ms(lambda: ref.flash_attention_bwd(
                    q, k, v, o, lse, do), reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library["ms"], "library": library,
                "profile": profile_update.profile_call(kern, 10)}

    def wkv_bwd_work(B, S, H, D, dtype):
        a = wkv_inputs(B, S, H, D, dtype, dev)
        args = [a[k] for k in ("r", "k", "v", "logw", "u")]
        do = wkv_inputs(B, S, H, D, dtype, dev, seed=1)["r"]
        n = B * S * H * D
        e = a["r"].element_size()
        # r, k, v, do and dr, dk, dv in their type; logw and dlogw f32; u
        # and du; the chunks' states are recomputed, not read
        nbytes = 7 * e * n + 2 * 4 * n + 2 * 4 * H * D
        # the state recurrence again (2 D² a token), then per token the
        # S and dS products of dqt, dko, dv and dS (8 D²) and the chunk's
        # pair terms (A, dA, dqt, dki, dv: 10 · 16 D)
        flops = B * H * S * (10.0 * D * D + 160.0 * D)
        b_ms, b_by = lm_bound(flops, nbytes, torch.float32)

        def kern():
            return rwkv6_wkv.wkv6_backward(*args, None, do,
                                           need_dstate=False)
        return {"shape": [B, S, H, D], "dtype": str(dtype),
                "ms": time_ms(kern),
                "plain_ms": time_ms(lambda: ref.wkv_backward(
                    *args, None, do), reps=3),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "profile": profile_update.profile_call(kern, 10)}

    q2 = configs.get_config("qwen2-0.5b")
    rw = configs.get_config("rwkv6-3b")
    qh = (q2.n_heads, q2.n_kv_heads, q2.head_dim)
    rh = (rw.d_model // rw.rwkv_head_dim, rw.rwkv_head_dim)
    c = TRAIN_CPU
    bf16, f32 = torch.bfloat16, torch.float32
    work = {
        "flash_attention_bwd": {
            "train_qwen2": flash_bwd_work(TRAIN["B"], TRAIN["S"], *qh, bf16),
            "train_card_vs_cpu": flash_bwd_work(c["B"], c["S"], 4, 2,
                                                c["head_dim"], f32)},
        "wkv6_backward": {
            "train_rwkv6": wkv_bwd_work(TRAIN_RWKV["B"], TRAIN_RWKV["S"],
                                        *rh, bf16),
            "train_card_vs_cpu": wkv_bwd_work(c["B"], c["S"], 2,
                                              c["head_dim"], f32)}}
    rows = []
    for name, paths in work.items():
        for p, w in paths.items():
            w["launches"] = launches[p][name]
        top = paths["train_qwen2" if name == "flash_attention_bwd"
                    else "train_rwkv6"]
        rows.append({"name": name, "route": "cuda",
                     "source": SOURCES[name][0], "replaces": SOURCES[name][1],
                     "launches": sum(launches[p][name] for p in launches),
                     "max_abs_err": errs[name],
                     **{k: top[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")},
                     "paths": paths})
    return rows


def kernel_work(shape, fid, dev, dtype=torch.float64):
    """Per kernel, in ``dtype`` at ``shape``: (kernel call, plain call, one
    PyTorch call of the same product, the GEMM's operations, bytes, Z
    elements drawn from the counter stream)."""
    S, lam, n = shape["S"], shape["lam"], shape["n"]
    a, sep = sample_inputs(S, lam, n, dtype, dev, fid=fid)
    u = update_inputs(S, lam, n, dtype, dev, zero_slot=False)
    lam_nz = int((u["w"] != 0).sum())          # weighted rows, all slots
    esz = torch.empty((), dtype=dtype).element_size()
    zd = (a["Z"] * a["D"][:, None, :]).contiguous()
    bt = a["B"].transpose(-1, -2)
    ys = (u["w"].sqrt()[..., None] * u["Y"]).contiguous()
    yst = ys.transpose(-1, -2)
    gemm_flops = 2.0 * S * lam * n * n
    draws = S * lam * n
    seeds = seed_words(S, dev)
    r = list(rng_args(a).values())
    return {
        "cma_gen_sample": (
            lambda: cma_gen.gen_sample(**a), lambda: ref.gen_sample(**a),
            lambda: torch.matmul(zd, bt), gemm_flops,
            esz * S * (3 * lam * n + n * n + 2 * n + 1), 0),
        "cma_gen_sample_eval": (
            lambda: kernel_eval(a, sep),
            lambda: ref.gen_sample_eval(**a, sep=sep),
            lambda: torch.matmul(zd, bt), gemm_flops + 4.0 * S * lam * n,
            esz * S * (2 * lam * n + lam + n * n + 4 * n + 1), 0),
        "cma_gen_update": (
            lambda: cma_gen.gen_update(**u), lambda: ref_update(u),
            lambda: torch.matmul(yst, ys),
            n * (n + 1) * lam_nz + 2.0 * lam_nz * n + S * 4.0 * n * n,
            esz * (S * (3 * n * n + lam + 8 * n + 7) + lam_nz * n), 0),
        "cma_gen_sample_rng": (
            lambda: cma_gen.gen_sample_rng(*r, seeds, lam),
            lambda: ref.gen_sample_rng(*r, seeds, lam),
            lambda: torch.matmul(zd, bt), gemm_flops,
            esz * S * (2 * lam * n + n * n + 2 * n + 1) + 8 * S, draws),
        "cma_gen_sample_rng_eval": (
            lambda: cma_gen.gen_sample_rng_eval(*r, seeds, lam, *sep),
            lambda: ref.gen_sample_rng_eval(*r, seeds, lam, sep),
            lambda: torch.matmul(zd, bt),
            gemm_flops + 4.0 * S * lam * n,
            esz * S * (lam * n + lam + n * n + 4 * n + 1) + 8 * S, draws),
        "cma_sample_z_rng": (
            lambda: cma_gen.sample_z_rng(seeds, lam, n),
            lambda: ref.sample_z_rng(seeds, lam, n), None, 0.0,
            esz * S * lam * n + 8 * S, draws),
    }


#: the Z-operand call each RNG sample call is held to (rows 3-4 to 1-2)
LOADED = {"cma_gen_sample_rng": "cma_gen_sample",
          "cma_gen_sample_rng_eval": "cma_gen_sample_eval"}


def recorded_kernels(call, windows=3):
    """The distinct CUDA kernels ``torch.profiler`` records for ``call``:
    their names over ``windows`` windows of 20 calls each, joined (the
    profiler drops launches, more of them late in the script: one window
    of an H100 run recorded none of a call's 20)."""
    names = set()
    for _ in range(windows):
        names |= set(profile_update.profile_call(call, 20)["kernels_us"])
    return len(names)


def kernels_a_call(work):
    """Per bucketed path, the CUDA kernels one call of rows 1-4 launches at
    the path's shape (``recorded_kernels``): an RNG call as many as its
    Z-operand call where it draws Z in the kernel, one more (row 5's)
    elsewhere."""
    out = {}
    for p in ("bucketed_rng_f8", "bucketed_rng_f1_restarts"):
        out[p] = {name: recorded_kernels(work[p][name][0])
                  for name in (*LOADED, *LOADED.values())}
        extra = 0 if sample_plan.draws_z(PATHS[p][0]["n"]) else 1
        for rng, loaded in LOADED.items():
            if out[p][rng] != out[p][loaded] + extra:
                raise AssertionError(f"{p}: {rng} launches {out[p][rng]} "
                                     f"kernels a call, {loaded} "
                                     f"{out[p][loaded]}")
    return out


def phase_table(dev, errs, launches):
    """Per kernel: its launches on each path (``launches`` maps a path to
    its counts), and its time, bound, plain and library time at each path's
    shape; the top-level numbers are those at the phase-3 shape, the
    launches those of every path together.  Rows 7 and 8 come from
    ``strategy_kernel_rows``."""
    work = {p: kernel_work(shape, fid, dev, *dt)
            for p, (shape, fid, *dt) in PATHS.items()}
    calls = kernels_a_call(work)
    rows, parts = [], {}
    for name in list(SOURCES)[:6]:
        paths = {}
        for p, w in work.items():
            kern, plain, lib, flops, nbytes, draws = w[name]
            dtype = (PATHS[p][2:] or (torch.float64,))[0]
            # the draw's instruction counts are float64's (phase 1): a
            # float32 row is bound by its bytes and its GEMM only
            draws = draws if dtype == torch.float64 else 0
            b_ms, b_by = bound(flops, nbytes, dtype, draws)
            parts[f"{name} {p}"] = {
                **bound_parts(flops, nbytes, dtype, draws),
                **({"issue_floor": issue_floor_ms(draws)}
                   if name == "cma_sample_z_rng" and draws else {})}
            shape = PATHS[p][0]
            paths[p] = {"shape": [shape["S"], shape["lam"], shape["n"]],
                        "dtype": str(dtype).replace("torch.", ""),
                        "launches": launches[p][name], "ms": time_ms(kern),
                        "plain_ms": time_ms(plain), "bound_ms": b_ms,
                        "bound_by": b_by,
                        "library_ms": None if lib is None else time_ms(lib),
                        **({"kernels_a_call": calls[p][name]}
                           if name in calls.get(p, {}) else {})}
        top = paths["main_path_f8"]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "launches": sum(launches[p][name] for p in launches),
            "max_abs_err": errs[name],
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "paths": paths})
    rows += strategy_kernel_rows(dev, errs, launches)
    rows += lm_kernel_rows(dev, errs, launches)
    rows += train_kernel_rows(dev, errs, launches)
    # the least ms of each resource behind rows 1-6's bounds (bound_parts)
    emit({"phase": "bound_parts_ms", "sm_clock_mhz": sm_clock_hz() / 1e6,
          "parts": parts})
    emit({"kernels": rows})


# ---------------------------------------------------------------------------
# the phases in groups: one worker process a group, all at once on the card
# ---------------------------------------------------------------------------

def run_phase(st, name, fn, *args):
    """Phase ``name``: ``fn(*args)``, its start and end (host clock) into
    ``st["spans"]``."""
    t0 = time.time()
    out = fn(*args)
    st["spans"][name] = [t0, time.time()]
    return out


#: per part of phase 12, its paths: (path, key of its launches, S, fid)
FLEET_PATHS = {
    "bucketed_auto": [("fleet_bucketed_auto_n40", None, 1, 1)],
    "bucketed_kernel_rng": [("fleet_bucketed_rng_n40", None, 1, 1)],
    "mesh": [("fleet_mesh_s2_n40", "concurrent", 1, 1),
             ("fleet_mesh_s1_n40", "ordered", FLEET["mesh_islands"], 1)],
    "service_reassign_rejoin": [("fleet_service_reassign_n40", None,
                                 FLEET_SERVICE["rows"], None)],
    "service_park": [("fleet_service_park_n40", None,
                      FLEET_SERVICE["rows"], None)]}


def fleet_step(dev, st, part, name):
    got, lam = run_phase(st, name, phase_fleet, dev, part)
    for path, key, S, fid in FLEET_PATHS[part]:
        st["launches"][path] = got if key is None else got[key]
        st["paths"][path] = (dict(RESTARTS, S=S, lam=lam), fid)


def group_engines(dev, st):
    """12a under ``kernel_rng``, then phases 2-4b and 6b."""
    L, P = st["launches"], st["paths"]
    fleet_step(dev, st, "bucketed_kernel_rng", "12a_fleet_bucketed_rng")
    st["errs"] = run_phase(st, "2_kernels", phase_kernels, dev)
    L["main_path_f8"], ladder_ms = run_phase(st, "3_main_path",
                                             phase_main_path, dev)
    L["bucketed_rng_f8"] = run_phase(st, "3b_bucketed", phase_bucketed_main,
                                     dev, ladder_ms)
    run_phase(st, "3c_small_bucketed", phase_small_bucketed, dev)
    L["ipop_f1_restarts"] = run_phase(st, "4_ipop", phase_ipop, dev)
    L["bucketed_rng_f1_restarts"], widest = run_phase(
        st, "4b_bucketed_restarts", phase_bucketed_restarts, dev)
    P["bucketed_rng_f1_restarts"] = (dict(RESTARTS, lam=widest), 1)
    L["strategies_small_card_vs_cpu"] = run_phase(
        st, "6b_small_strategies", phase_small_strategies, dev)


def group_campaigns(dev, st):
    """12a under ``auto``, then phases 9, 6 and 6c."""
    L, P = st["launches"], st["paths"]
    fleet_step(dev, st, "bucketed_auto", "12a_fleet_bucketed_auto")
    L["campaign_bbob24_n40"], widest = run_phase(
        st, "9_campaign_n40", phase_campaign_n40, dev)
    P["campaign_bbob24_n40"] = (dict(RESTARTS, S=24 * 2, lam=widest), None)
    L["strategies_kdist_f8"] = run_phase(st, "6_strategies",
                                         phase_strategies, dev)
    L["strategies_krep_n1000"] = run_phase(st, "6c_krep", phase_krep_n1000,
                                           dev)


def group_mesh(dev, st):
    """12b, then phases 10-10c and 9c-9e."""
    L, P = st["launches"], st["paths"]
    fleet_step(dev, st, "mesh", "12b_fleet_mesh")
    mesh = run_phase(st, "10_mesh_n1000", phase_mesh_n1000, dev)
    L["mesh_n1000_s1"] = mesh["ordered"]
    L["mesh_n1000_s2"] = mesh["concurrent"]
    L["mesh_n1000_bucketed"] = mesh["bucketed"]
    mesh, widest = run_phase(st, "10b_mesh_campaign_n40",
                             phase_mesh_campaign_n40, dev)
    for tag, strategy, S in (("s1", "ordered", 48),
                             ("s2", "concurrent",
                              48 // MESH_CAMPAIGN["islands"])):
        L[f"mesh_campaign_n40_{tag}"] = mesh[strategy]
        P[f"mesh_campaign_n40_{tag}"] = (
            dict(RESTARTS, S=S, lam=widest[strategy]), None)
    L["mesh_card_vs_cpu"] = run_phase(st, "10c_mesh_card_vs_cpu",
                                      phase_mesh_card_vs_cpu, dev)
    L["campaign_card_vs_cpu"] = run_phase(
        st, "9c_campaign_card_vs_cpu", phase_campaign_card_vs_cpu, dev)
    L["campaign_bbob24_n1000"] = run_phase(st, "9d_campaign_n1000",
                                           phase_campaign_wide, dev)
    run_phase(st, "9e_no_fallback", phase_no_fallback, dev)


def group_service(dev, st):
    """12c's reassigning run, then phases 11-11c, 9b, 4d and 7c."""
    L, P = st["launches"], st["paths"]
    fleet_step(dev, st, "service_reassign_rejoin", "12c_fleet_reassign")
    L["service_stream_n40"], widest = run_phase(
        st, "11_service_stream_n40", phase_service_stream, dev)
    P["service_stream_n40"] = (dict(RESTARTS, S=SERVICE["rows"], lam=widest),
                               None)
    L["service_snapshot_n40"], widest = run_phase(
        st, "11b_service_snapshot_resume", phase_service_snapshot, dev)
    P["service_snapshot_n40"] = (dict(RESTARTS, S=SERVICE["rows"],
                                      lam=widest), None)
    L["service_card_vs_cpu"], widest = run_phase(
        st, "11c_service_card_vs_cpu", phase_service_card_vs_cpu, dev)
    P["service_card_vs_cpu"] = (dict(S=4, lam=widest, n=SERVICE_SMALL["n"]),
                                None)
    L["campaign_sep_rng_n40"], widest = run_phase(
        st, "9b_campaign_sep_rng", phase_campaign_sep_rng, dev)
    P["campaign_sep_rng_n40"] = (
        dict(RESTARTS, S=CAMPAIGN_SEP_SLOTS, lam=widest), None)
    L["hostloop_f1"] = run_phase(st, "4d_hostloop", phase_hostloop, dev)
    L["serve_card_vs_cpu"] = run_phase(st, "7c_card_vs_cpu",
                                       phase_card_vs_cpu, dev)


def group_lm(dev, st):
    """12c's parking run, then phases 4c, 7, 7b and 8."""
    L, P = st["launches"], st["paths"]
    fleet_step(dev, st, "service_park", "12c_fleet_park")
    L["float32_f1"] = run_phase(st, "4c_float32", phase_float32, dev)
    P["float32_f1"] = (RESTARTS, 1, torch.float32)
    L["serve_qwen2"] = run_phase(st, "7_serve_qwen2", phase_serve, dev,
                                 "qwen2-0.5b")
    torch.cuda.empty_cache()
    L["serve_rwkv6"] = run_phase(st, "7b_serve_rwkv6", phase_serve, dev,
                                 "rwkv6-3b")
    torch.cuda.empty_cache()
    L["nn_fitness_qwen2"], shape = run_phase(st, "8_nn_fitness",
                                             phase_nn_fitness, dev)
    P["nn_fitness_qwen2"] = (shape, None)


def group_train(dev, st):
    """Phases 13a-13d: the dense descent and training; then 14a-14f: the
    other LM families served, and card against CPU."""
    L, P = st["launches"], st["paths"]
    L["descent_f8_n1000"], L["descent_card_vs_cpu"] = run_phase(
        st, "13a_descent", phase_descent, dev)
    P["descent_f8_n1000"] = (dict(S=1, lam=default_lam(DESCENT["n"]),
                                  n=DESCENT["n"]), None)
    L["train_qwen2"] = run_phase(st, "13b_train_qwen2", phase_train_qwen2,
                                 dev)
    torch.cuda.empty_cache()
    L["train_rwkv6"] = run_phase(st, "13c_train_rwkv6", phase_train_rwkv6,
                                 dev)
    torch.cuda.empty_cache()
    L["train_card_vs_cpu"] = run_phase(st, "13d_train_card_vs_cpu",
                                       phase_train_card_vs_cpu, dev)
    torch.cuda.empty_cache()
    for arch, f in FAMILIES.items():
        got = run_phase(st, f["phase"], phase_serve_family, dev, arch)
        if arch == "gemma3-4b":
            for part, counts in got.items():
                L[f"{f['tag']}_{part}"] = counts
        else:
            L[f["tag"]] = got
        torch.cuda.empty_cache()
    L["families_card_vs_cpu"] = run_phase(st, "14f_families_card_vs_cpu",
                                          phase_families_card_vs_cpu, dev)


#: the phases between the build (phase 1) and the kernels line (phase 5),
#: in five groups of about equal time (the phases' seconds with the five
#: at once on an H100 80GB HBM3 at 700.00 W: 280-330 s a group, from 160-
#: 190 s alone) and a sixth that trains (13a-13d) and serves the families
#: of the other LM families (14a-14f).  Each group runs in a
#: worker process of its own, all at once: a CMA-ES step is host-bound
#: (the card is busy a third of it), so the workers share the card's idle
#: time.  Phase 12's five parts come first, each in its own worker.
GROUPS = {"engines": group_engines, "campaigns": group_campaigns,
          "mesh": group_mesh, "service": group_service, "lm": group_lm,
          "train": group_train}


def new_state():
    return {"launches": {}, "paths": {}, "spans": {}, "errs": None}


def _plain(x):
    """JSON for the numpy and torch scalars of a group's state."""
    if isinstance(x, torch.dtype):
        return str(x)
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    raise TypeError(f"{type(x).__name__} in a group's state")


def load_state(text):
    """A worker's state, its paths' dtypes back to ``torch.dtype``."""
    st = json.loads(text)
    st["paths"] = {p: (v[0], v[1], *(getattr(torch, t.split(".")[-1])
                                     for t in v[2:]))
                   for p, v in st["paths"].items()}
    return st


def setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def worker(group, out, threads):
    """Run one group on the card; its state to ``out`` as JSON.  The
    worker is killed when its parent dies."""
    import ctypes
    import signal
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)       # PR_SET_PDEATHSIG
    dev = torch.device("cuda")
    setup()
    torch.set_num_threads(threads)
    st = new_state()
    GROUPS[group](dev, st)
    Path(out).write_text(json.dumps(st, default=_plain))


def spawn_groups(tmp, threads):
    """One worker process a group, all at once, each printing to
    ``tmp/<group>.out`` and leaving its state in ``tmp/<group>.json``.
    When one fails the others are killed; every worker has ended on
    return.  Returns each group's exit code and wall seconds."""
    procs, walls = {}, {}
    t0 = time.time()
    try:
        for g in GROUPS:
            with open(tmp / f"{g}.out", "w") as log:
                procs[g] = subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--group", g, "--out", str(tmp / f"{g}.json"),
                     "--threads", str(threads)], stdout=log)
        while len(walls) < len(procs):
            for g, p in procs.items():
                if g not in walls and p.poll() is not None:
                    walls[g] = time.time() - t0
            if any(p.returncode for p in procs.values()):
                break
            time.sleep(0.2)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    return {g: p.returncode for g, p in procs.items()}, walls


def run_groups(dev, serial=False):
    """Every group's state: with ``serial``, one after another in this
    process; otherwise one worker process each, all at once
    (``spawn_groups``), their lines printed in ``GROUPS``' order when all
    have ended."""
    if serial:
        states = {}
        for g, fn in GROUPS.items():
            states[g] = new_state()
            fn(dev, states[g])
        return states, {}
    threads = max(1, len(os.sched_getaffinity(0)) // len(GROUPS))
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        rcs, walls = spawn_groups(tmp, threads)
        for g in GROUPS:
            if (tmp / f"{g}.out").exists():
                sys.stdout.write((tmp / f"{g}.out").read_text())
        sys.stdout.flush()
        failed = {g: rc for g, rc in rcs.items() if rc}
        if failed or len(rcs) < len(GROUPS):
            raise SystemExit(f"chip_smoke.py: phase groups failed (exit "
                             f"codes; -9: stopped after another failed): "
                             f"{failed}")
        states = {g: load_state((tmp / f"{g}.json").read_text())
                  for g in GROUPS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return states, {"workers": len(GROUPS), "threads": threads,
                    "wall_s": walls}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--serial", action="store_true",
                    help="run the phase groups one after another in this "
                         "process (default: a worker process a group, all "
                         "at once)")
    ap.add_argument("--group", choices=GROUPS, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--threads", type=int, default=1, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device")
    if args.group:
        worker(args.group, args.out, args.threads)
        return 0
    dev = torch.device("cuda")
    t0 = time.time()
    phase_build(dev)
    seconds = {"1_build": time.time() - t0}
    states, run = run_groups(dev, args.serial)
    launches, spans, errs = {}, {}, None
    for st in states.values():
        launches.update(st["launches"])
        PATHS.update(st["paths"])
        spans.update(st["spans"])
        errs = st["errs"] or errs
    seconds.update({k: e - s for k, (s, e) in spans.items()})
    parts = [spans[k] for k in spans if k.startswith("12")]
    emit({"phase": "fleet", "span_s": max(e for _s, e in parts)
          - min(s for s, _e in parts),
          "parts_s": {k: seconds[k] for k in spans if k.startswith("12")}})
    emit({"phase": "groups", **run, "serial": args.serial,
          "phases": {g: list(st["spans"]) for g, st in states.items()},
          "after_build_s": time.time() - t0 - seconds["1_build"]})
    t1 = time.time()
    phase_table(dev, errs, launches)
    seconds["5_table"] = time.time() - t1
    emit({"phase_seconds": seconds, "total_s": time.time() - t0})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
