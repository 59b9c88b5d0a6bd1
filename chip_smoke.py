#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``paddle_tpu_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --parent DIR``, with the parent commit's tree
unpacked in DIR, also times the parent's int8 (decode and prefill),
grouped, paged decode, CE, flash backward, RMSNorm forward and RoPE
kernels against this tree's in turns after phase 3 (the CE backward's outputs must be equal
bit for bit). ``--sweep`` also times the RMSNorm forward and RoPE under
other plan constants in phase 3 (``norm_rope_plan_sweep``, each held
bit for bit to the default plan's output).

Phases, in order; any failure exits non-zero before the result line:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``paddle_tpu_torch/csrc`` and print the
     build seconds;
  3. per kernel: run it and its plain PyTorch version on the serving
     and training paths' shapes, print the errors against the stated
     tolerance (the flash kernels and bf16 paged decode also per row,
     and a planted wrong tile or page must fail that check), and time
     kernel, plain version and library call (CUDA events, L2 flushed and
     the host given a head start before every launch, median of 25 after
     warm-up; 10 for slow plain versions). First the launch floor: an
     empty kernel timed the same way. The RMSNorm and RoPE forwards at
     a decode step (B = 8), a 1024-token prefill, a speculative verify
     (B = 8 rows of 5 tokens; RoPE's row 0 at positions running past the
     table, clamped), a 512-token prefill chunk and a training step
     (8192 x 4096 and DeepSeekMoE's 8192 x 2048; b = 2, s = 4096 at
     32/8 and 16/16 heads), RMSNorm's rstd held to 1e-5; a row with its
     last vector dropped and decode positions off by one must fail those
     checks; their launches a call and launches x the gap to
     max(bound, floor) read after phase 9 (``norm_rope_gaps``). Training
     kernels: the RMSNorm backward at 8192 x 4096; the flash forward and backward at
     b=2, s=4096, 32 heads over 8 KV heads, d=128, bf16, causal (with
     TFLOP/s; a K/V tile planted in place of another must break out and
     dq, a Q/dO/lse/delta tile dk and dv); flash also in fp32 at s=1024,
     with segment ids (fully masked rows included), with dropout p=0.1
     and at a ragged s=1000; every bf16 flash backward case, and the
     training shape at d = 64 and d = 32, run twice: dq, dk and dv equal
     bit for bit (D14: the dQ adds go in a fixed order); the fused
     vocab-CE kernels
     (forward, dlog, dh, dW) at 8192 tokens x hidden 4096 x vocabulary
     128256 in bf16 (lse/tgt to 1e-4, dlog, dh and dW per row or column,
     and two planted wrong vocabulary blocks that every check must
     reject; the backward's TFLOP/s and share of the bound), dlog, dh and
     dW of one chunk at the DeepSeekMoE-16B head (hidden 2048,
     vocabulary 102400) beside torch.matmul, and in fp32 at 2048 x 1024 x 20000 with ignored rows and a
     tied, transposed W through the autograd Function;
     Quantized serving: the int8 matrix product at the five projections
     of a Llama-3-8B decode step (m = 8, bf16; each also beside a
     streaming read of its weight's bytes), at gate_up with m = 128
     and m = 1024 (prefills, with TFLOP/s and share of the bound), at
     the five projections with m = 40 (a verify of B = 8, spec_k = 4)
     and at qkv, o, gate_up and down with m = 512 (a prefill chunk), and
     in fp32 at m = 5, n = 384, k = 256, held per 128 columns of each
     output row in bf16 (a weight with one 64-wide k-block swapped and a
     scale vector with one block of channels shifted must fail that
     check at qkv and down, at decode and at m = 40, at the m = 1024
     prefill and at the m = 512 gate_up chunk), beside one
     torch.matmul with the bf16 weight; the int8
     paged decode at B = 8, context 1024, page 128 (bf16 and fp32 q, and
     a ragged case with a page never written), per row, where a page
     read with another page's K or V scale must fail; both paged decode
     kernels also at contexts 128 to 2048 beside a streaming read of the
     same K and V bytes;
     MoE: the grouped matmul at the bf16 dropless DeepSeekMoE-16B
     step's shapes (m = 49152 rows, 64 experts; gate_up k 2048, n 2816
     and down k 1408, n 2048; balanced and skewed counts with a quarter
     of the experts empty): forward, dx (the forward kernel reading the
     weight transposed) and dW, per row, with TFLOP/s and share of the
     bound, beside torch._grouped_mm (or a matmul loop where that is
     missing); a planted wrong tile→group and a planted dW row shift must
     fail, and dW must be the same bit for bit on a second run; fp32 at
     a small ragged shape; with --parent, the parent's int8 and grouped
     kernels against this tree's in turns;
  4. engine equality: Llama-3-8B widths at 2 layers, fp32, seeded random
     weights: greedy tokens of the engine on the card equal those of a
     step-by-step plain-version path on the CPU;
  4b. quantized engine equality: the same widths and depth with int8
     weights and int8 KV, the same seeded weights on the card and on the
     CPU: teacher-forced logits within QUANT_LOGIT_TOL, the pools' codes
     equal but for differences of 1 at no more than QUANT_CODE_FRAC of
     them and the page scales within QUANT_SCALE_RTOL, for a paged
     prefill and 8 decode steps, and for the feature entry points (prefill
     chunks of 4 rows x 128 tokens at offsets 0 and 128, then two
     verifies of 8 rows x 5 tokens, the second over part of the first)
     with the codes held per layer (QUANT_CODE_FRAC_LATER after the
     first); beside each reading, what a 2e-6 perturbation of every
     projection does on the CPU (``perturbed``);
     the two engines' greedy agreement reported;
  4c. feature equality: Llama-3-8B widths at 2 layers, fp32, seeded
     weights, page_size 128, max_batch 4: greedy tokens of the engine on
     the card equal the plain path on the CPU for every request of a
     chunked-prefill run (prompts of 300-700 tokens, prefill_chunk 256),
     a prefix-cache run (six prompts sharing a 512-token prefix, then one
     submitted again whole: copy on write), a spec_k = 4 run, a spec_k =
     4 run at async_depth 2 whose drafts are the plain path's own tokens
     (it must accept drafts; eos and budgets end inside accepted runs)
     and all three features at async_depth 2; two verify ticks (greedy
     and sampled) and one prefill chunk then run under
     torch.cuda.set_sync_debug_mode("error");
  4d. fabric equality: the same widths and depth, fp32, seeded weights:
     phase 4's four prompts and two of 300 and 450 tokens through
     ServingFabric(InProcTransport(build_replicas(model, 2, roles=
     ["prefill", "both"], page_size=128, max_len=512)),
     disagg_threshold_tokens=128): every prompt at or over the threshold
     handed off, greedy tokens equal the plain path, pages exported ==
     adopted > 0, the adopted pages the exporter's bit for bit; a
     forced-dense engine (attn_crossover = max_len) gives the paged
     engine's tokens. The int8 arm runs the same fabric over the
     quantized model one request at a time, against one int8 engine
     with the prefix cache that serves a handed-off prompt as the fabric
     does (a one-token prefill, then the request over its cached pages):
     equal tokens, codes and scales adopted bit for bit, a v1 payload
     refused;
  4e. front-door equality: 4d's model and prompts (untimed) through a
     FrontDoor over BreakerTransport(InProcTransport(prefill + "both"
     replicas)), clients in their own process: greedy streams equal
     4d's, sampled ones a serial engine's under the rseeds the door
     recorded; a torn frame gets an error event on a connection that
     lives, seq gapless; a disconnect then a retry loses and repeats no
     token; a client that never reads is evicted with its slot and
     pages returned while eight others finish; a replica hung after a
     handoff trips its breaker, the streams finish on the survivor
     exactly and the probe readmits it; a deadline miss and an overload
     are refused typed with retry_after_ms; an int8 replica pair serves
     three prompts equal to 4d's single int8 engine;
  4f. generation equality: phase 4's model (fp32, 2 layers, seed 7, TF32
     off) and its CPU copy; 2 prompts of 120 tokens with 16 new (the
     decode crosses the page edge at 128) and 1 prompt of 128 with 8
     new: ``generate``, ``generate_scan`` and ``generate_paged(page_size=
     128)`` on the card give equal tokens for every row, equal to
     ``plain_greedy`` on the CPU copy; ``generate_scan`` with row 0's
     first greedy token as EOS and pad -7 equals the same call on the
     CPU; a sampled ``generate_scan`` (temperature 0.8, top-k 50, top-p
     0.9, seed 3) gives the same tokens twice and equals ``generate``;
     after a warm call ``generate_scan`` and ``generate_paged`` run
     under torch.cuda.set_sync_debug_mode("error"); 4f on a mesh runs
     after phase 12 (below);
  5. the serving run: Llama-3-8B widths, all 32 layers, bf16, seeded
     random weights built on the card; 16 requests (prompts 128-1536
     tokens, 64 new tokens, every 4th sampled) through
     ContinuousBatchingEngine(max_batch=8, page_size=128, max_len=2048,
     decode_block=8, async_depth=2). Kernel launch counts are reset just
     before and read just after; every serving kernel must have launched;
     then the launches of one call of each paged entry point and one
     decode step profiled, with RMSNorm's and RoPE's device us;
  3c. the crossover sweep, on phase 5's model after it (and on 5b's):
     one decode step (decode_step_paged and the head) at B = 8 and
     contexts 128 to 8192 under the paged kernel and the dense route
     (CUDA events, median of 10), and one layer's attention alone under
     each (median of 25, L2 flushed); prints both and the crossover they
     imply beside the port's default paged_decode_crossover(); writes
     that crossover into a user TuneDB (``chiprun_out/tune_db.json``
     through PT_TUNE_DB) and fails unless paged_decode_crossover() reads
     it back;
  5d. the fabric run, on phase 5's model after 5c's native runs (and on
     5b's): phase 5's 16 requests through ServingFabric(InProcTransport(
     build_replicas(model, 2, roles=["prefill", "both"], **phase 5's
     engine settings)), policy="affinity", disagg_threshold_tokens=512):
     requests sent / succeeded / failed, tokens/s, TTFT and ITL, requests
     handed off, pages exported / adopted, extract and adopt ms a page,
     attention-route ticks by replica and launches, beside phase 5's (or
     5b's) numbers of the same call; a failed request, no adopted page or
     a serving kernel not launched fails it;
  5e. the front door, on phase 5's model after 5d's native run: phase
     5's 16 requests from 16 FabricClients in a client process of their
     own (``--client-process``: it imports ``serving_fabric.client`` and
     no torch) through FrontDoor(ServingFabric(BreakerTransport(
     InProcTransport(5d's two replicas)))), with the metrics registry
     on, the SLO sentry's serving, fabric and front-door packs installed
     (``min_interval_s=1.0``) and the window in
     ``profiler.serving_trace``: tokens/s, TTFT and ITL at the client
     and at the router beside 5d's, the sentry's ticks, tick ms and
     incidents, host ms per span, breaker trips (0) and the longest
     healthy op, launches; greedy streams equal 5d's, and each
     router-level latency rule fires iff the router's p99 is over its
     ceiling. Then the hang leg on fresh replicas: the prefill replica
     hung after its 4th handoff under an op budget of 3x that longest
     op (at least 1 s): one trip within 2x the budget, its requests
     served by the "both" replica, readmission once released, greedy
     streams equal 5d's (or, for a long prompt served cold, one engine
     serving it cold);
  5f. one-shot generation, on phase 5's model after 5e (and on the int8
     model after 5d's int8 arm): 8 prompts of 512 tokens (seed 12), 64
     new, page 128, through ``generate``, ``generate_scan`` and
     ``generate_paged``, each a warm call then a timed one: wall time,
     tokens/s (8 x 64 / wall) and the prefill's device span inside the
     timed call (CUDA events around the model's prefill), beside the card's
     name and power limit; ``generate`` must equal ``generate_scan``
     token for token, and one ``generate_paged`` call must launch
     RMSNorm 64 x 65, RoPE 64 x 32 and the paged decode kernel (its int8
     half on the int8 model) 63 x 32 times, the int8 product 64 x 129
     times (128 on its wgmma route: the prefill's projections, the rest
     on its decode route); reported only: the dense-vs-paged token
     agreement and the device idle share of one ``generate_scan`` call
     (torch.profiler, the device's activity alone: ``profile_step``);
  5b. the quantized serving run: the same model quantized on the card
     (int8 weights and KV, the native model then freed) through the same
     run, side by side with phase 5: tokens/s, TTFT, ITL, one decode
     step, launches, model and KV-pool bytes, peak memory, and the greedy
     agreement with phase 5's streams (reported only); every int8
     product of a prefill must take the kernel's wgmma route;
  5c. the feature runs, on phase 5's model between 5 and 5b: phase 5's
     16 requests with chunked prefill (prefill_chunk 512); 16 requests
     of a shared 1024-token system prompt and a 128-512-token suffix
     (seed 12), then 8 of them again as prompt + output up to its last
     whole page (full hits) with the prefix cache; phase 5's requests
     with spec_k 4; after 5b the prefix traffic on the int8 model with
     all three. Each prints requests sent / succeeded / failed, tokens/s,
     TTFT and ITL p50 and p99, the prefix hit tokens, hit rate and
     copies on write or the acceptance rate and mean accepted length,
     and launches by kernel (RMSNorm and RoPE in every run, paged decode
     in the chunked and prefix runs, both int8 routes in the int8 run),
     each beside the card's name and power limit; then the context
     attention's device ms in one profiled prefill chunk and one verify
     tick. A failed request, a missing launch, no hit (or fewer than 8
     copies on write) or no scored draft fails the run;
  6. training equality: Llama-3-8B's attention layout (hidden 4096, 32
     heads, 8 KV heads of 128) at 2 layers with the MLP cut to 1024 and
     the vocabulary to 4096, the default (fused) loss head, the same
     seeded weights and batch (segment ids included) on the card
     (kernels) and on the CPU (plain versions): in fp32, first-step
     gradients and 3 AdamW steps' losses agree; in bf16 (the flash
     kernels' Hopper route), the first step's loss and gradients
     agree; in fp32 with recompute "full" and "selective", the card's
     first-step gradients equal those without recompute within 1e-6;
  7. the training run: Llama-3-8B widths at 4 layers, bf16, the default
     configuration (fused vocab-CE head), AdamW(1e-4, weight_decay=0.01)
     with global-norm clip 1.0, batch 2 x 4096 tokens from a numpy seed,
     the same batch every step: 2 warm-up and 8 timed steps through
     Trainer.fit, launch counts reset just before and read just after;
     tokens/s, step time, MFU, peak memory, the device idle share of one
     step, and launches per step. Every training kernel must launch and
     the loss must be finite and fall. Then 2 + 4 steps each of the
     naive head and of recompute "full" and "selective" on the same
     batch (step time, peak memory); the default run's peak memory must
     lie below the naive head's. The cost leg, after the default run's
     timed steps: one more step with the metrics registry on (its census,
     ``observability.costs.CostWatch``), then the gauges published for
     the timed steps' median: the census MFU beside the PaLM MFU and
     their ratio, and the breakdown's buckets must sum to the step
     within 1e-9 relative;
  8. MoE equality: one dropless MoELayer at DeepSeekMoE-16B widths,
     forward and backward, under torch.cuda.set_sync_debug_mode("error");
     then DeepSeekMoE-16B's layout at 2 layers (dense MLP 1024,
     vocabulary 4096), dropless, the same seeded weights and batch on the
     card and on the CPU: tokens whose routing ids differ (none in fp32),
     the first step's loss (fp32 rtol 1e-4, bf16 1e-2) and fp32
     gradients (1e-4 of each tensor's largest);
  9. the MoE training run: DeepSeekMoE-16B widths at 4 layers (1 dense +
     3 MoE), bf16, dropless, as phase 7 (2 warm-up + 8 timed steps,
     launch counts, one profiled step: grouped-matmul ms, routing ops,
     idle share); every training kernel and both grouped-matmul kernels
     must launch, every grouped launch on the wgmma route, and the loss
     must be finite and fall. Then 2 + 4 steps at capacity_factor 1.25
     beside it;
 10. the trainer runtime, at phase 7's configuration (Llama-3-8B widths
     at 4 layers, bf16, fused head, AdamW(1e-4, weight_decay 0.01) with
     global-norm clip 1.0), batches of 2 x 4096 tokens from the port's
     DataLoader over a seeded numpy token dataset with
     prefetch_to_device=True; launch counts reset before the first leg
     and read after (e), every training kernel must launch. The machine
     with the card ends a command that writes 45 GiB to its disk, so
     the legs that save are cut (SAVE_LAYERS, BC_LAYERS). (b, skip) a
     chaos.nan_batch at step 4 under AnomalyGuard(policy="skip"),
     donate=False: the step skipped, the parameters equal their
     pre-step values bit for bit, the cursor past the batch, the peak
     memory of the pre-step copy; (a) at 1 layer: 6 steps under
     CheckpointManager(save_interval_steps=3, keep_last_n=1,
     async_save=True): the state's bytes, the disk's free bytes, each
     save's synchronous snapshot and background write + sha256 seconds
     and GB/s, the steps saved (3 async, 6 sync) and committed ([6]); a
     fresh Trainer over a model from another seed resumes with
     resume="auto" (verify and restore seconds) and holds every
     parameter, master and moment, the step, the scheduler and the data
     cursor bit for bit; its next 2 losses must lie in the band of two
     uninterrupted runs (the saver going on, and a fresh run: their
     losses at each step widened by their largest difference); (b,
     rollback) and (c) at phase 6's layout in fp32 and 1 layer: a NaN
     batch at step
     4 under policy="rollback" restores step 3's state bit for bit, the
     loader replays from cursor 3, the goodput ledger books
     rollback_wasted, and the run ends on an unpoisoned run's state bit
     for bit; then PreemptionGuard.trigger() at step 6: one final
     synchronous checkpoint ([6]), TrainingPreempted with exit code 75,
     the flight recorder's dump, pt_preemptions_total 1, and a fresh
     trainer resumes it bit for bit and goes on a step; (d)
     steps_per_dispatch=4 against 1, 2 warm-up and 8 steps each: step
     time, the host's loss reads, the idle share of one profiled
     dispatch, and the K=4 run's largest loss distance from K=1; at
     phase 7's widths and depth in bf16 and in fp32 (every kernel
     deterministic), 6 steps each, K=4 must equal K=1 bit for
     bit, losses and state, and the
     steps saved under save_interval_steps=3 (read by a recorder that
     writes nothing) must be JAX's (SUPERSTEP_SAVES); (e) offload_opt_state=True: one update from the
     same gradients with the state in pinned host memory equals the
     update on the card bit for bit, then 2 + 4 steps: peak memory and
     step time; (f) the kill leg in fp32 at phase 6's layout:
     testing/_chaos_train.py through
     chaos.spawn_trainer on the card, an uninterrupted run beside one
     saving every 3 steps and SIGKILLed at step 7 after its async save
     of step 6 is durable; a fresh process resumes it: the final
     parameters equal the uninterrupted run's bit for bit, latest_step
     skips the torn step 6 and the manager quarantines it. Every
     checkpoint lives in the output directory (ROOT_OUT) and is removed
     at the end of its leg;
 11. the optimizers (writing nothing to disk): (a) SGD, Momentum,
     Adamax, Adagrad, RMSProp (centered: three slots), Adadelta, Lamb
     and Rprop (no masters by default: bf16 parameters updated through
     fp32 copies, D15), each at learning_rate 1e-4, weight decay 0.01
     where it takes one (Lamb's lamb_weight_decay), global-norm clip
     1.0, on phase 7's model and batch (one model, its seeded weights
     copied back in before each), 2 warm-up and 4 timed steps through
     Trainer.fit: median step, peak memory, losses and whether they fell
     (reported only); launch counts reset before the first run and read
     after the last, every training kernel launched in each run, every
     loss finite; (b) phase 6's fp32 model's first-step gradients of two
     batches on the card, applied by each optimizer (no clip) on the
     card and on the CPU from the same fresh state: parameters and slots within
     UPDATE_RTOL (max |card - cpu| / max |cpu| per tensor); the same
     layout in bf16 under Rprop without masters within one bf16 step;
     (c) RMSProp (centered) and Rprop: one update of phase 7's model with
     the state streamed from pinned host memory equals the update on
     the card bit for bit; (d) LBFGS(history_size=10, max_iter=10,
     strong_wolfe) on phase 6's fp32 model and one batch: the loss must
     fall; closure evaluations, seconds each, the history's bytes; (e)
     GradScaler over AdamW at phase 6's fp32 layout: a finite scaled step
     within UPDATE_RTOL of an unscaled one, two chaos.nan_batch steps
     skipped with the parameters unchanged bit for bit, the scale halved
     after the second;
 12. the device mesh (writing nothing to disk; one card, so NCCL runs
     one rank and the multi-rank algorithms run over virtual ranks):
     (a) init_parallel_env brings up NCCL at world size 1 and fleet.init
     a mesh with every axis 1; phase 7's model and batch (seed 10, 4
     layers, bf16, fused head, AdamW with clip 1.0), sequence_parallel
     on, through shard_layer, group_sharded_parallel("p_g_os", FSDP2 at
     fsdp 1), fleet.distributed_model and distributed_optimizer, 2 + 4
     steps; the losses and final parameters must equal the plain path's
     (the same 2 + 4 steps without the mesh) bit for bit, every training
     kernel launched in the timed steps; step time and peak memory of
     both; (b) the ring (parallel.ring_attention's step and merge
     functions) over 4 virtual ranks, b 1, s 16384, 32/8 heads, d 128,
     bf16, causal: out, lse, dq, dk, dv within 2e-2 of flash over the
     whole sequence (per row, as phase 3), with and without four uneven
     segments; 10 forward and 10 backward launches (6 blocks skipped);
     rows with no key in a block at lse -1e30 and out 0; the backward
     twice, bit for bit; the block kernels' summed times against the
     whole-sequence kernels'; (c) the vocab-parallel CE over 4 virtual
     shards (N 8192, H 4096, V 128256): nll, dh, dW within 2e-2 of the
     whole-vocab head, the shards' time against one whole call;
     then 4f on a mesh: 4f's model again, NCCL at world size 1,
     ``shard_layer`` of a copy, ``generate_scan`` and ``generate_paged``
     on 4f's first case: tokens equal to the unsharded model's bit for
     bit, and the sharded calls' RMSNorm, RoPE and paged decode launches
     counted (``launches_by_path["generation_mesh"]``);
 13. pipeline and expert parallelism over virtual stages and ranks
     (writing nothing to disk): (a) ``LlamaForCausalLMPipe`` at
     Llama-3-8B widths, 4 layers, 4 virtual stages, 4 microbatches,
     batch 4 x 4096, bf16, fused head, loaded from the unpipelined
     Llama of phase 7's seed: its first fused 1F1B step's loss within
     1e-2 of the unpipelined model's on the same batch and every
     gradient within ROW_TOL per row; then 2 + 4 Trainer steps (AdamW,
     clip 1.0) each of the 1F1B pipe (every training kernel launched),
     the GPipe pipe and the plain path, with step times and peak memory;
     (b) one dropless MoE layer at DeepSeekMoE-16B widths over 8192
     tokens split among 4 virtual ep ranks (``forward_virtual_ep``)
     against the layer on the whole batch: outputs, input and weight
     gradients per row, the aux loss; every grouped launch on the wgmma
     route; the host syncs of its forward and backward counted.
 14. the launcher, DistModel and the projection's inputs (writing only
     launcher logs, under ``chiprun_out/launch_logs``): (a) the port's
     launcher (``distributed.launch``, ``--devices`` this process's
     own card, ``max_restarts`` 1) starts a 1-rank pod of this script
     (``--launch-worker``) whose first start exits 3 (a planted
     failure, relaunched once), second exits 75 (resumable: relaunched
     without spending the restart budget) and third takes phase 7's 2 +
     4 steps at 2 layers; the launch must return 0 after 3 starts, the
     worker's card (its UUID) be this process's, and the losses equal
     the same steps run in this process bit for bit,
     every training kernel launched in the worker's timed steps; (b)
     ``distributed.compat.DistModel`` trains phase 7's model (4 layers)
     for 2 + 4 steps: its losses equal the Trainer's bit for bit; (c)
     ``tools/bench_8b_layer.py`` at b 1, s 8192, bf16: one Llama-3-8B
     layer forward and backward, with and without recompute, the fused
     CE head a token and its linearity, the embedding (the projection's
     ``measured``), every training kernel launched; then
     ``parallel.scale.train_state_bytes`` of phase 7's configuration
     beside phase 7's measured peak memory, as a ratio.
 15. the sharding planner, the plan-aware checkpoint and its resharded
     read (writing one 2.5 GB checkpoint under ``chiprun_out/plan_ckpt``,
     removed after): (a) ``auto_parallel.plan`` for Llama-3-8B (32
     layers, published widths, bf16, fused head, recompute "full") on 4
     and on 8 H100s at a global batch of 8 x 8192: the ranked table's
     top 5, the count pruned by the memory model (capacity from the
     card), the choice and each plan's seconds; at least one feasible
     config, every ranked estimate within the card's memory, a non-zero
     collective census for every config of more than one rank, and no
     memory allocated on the card by the pricing; then
     ``tools/op_cost_probe --calibrate`` on this card (the micro
     training step and its three dominant matmuls, into
     ``chiprun_out/op_cost_db.json``) and dp4 and tp4 of the rank-order
     model (Llama-3-8B widths, 2 layers, 4 x 4096) priced from one census
     each without and with that OpCostDB, beside the steps measured for
     it on four cards by ``tools/elastic_check.py``'s rank-order pod
     (≈135 and ≈77 ms, PERF.md); (b) ``Trainer.
     apply_plan`` of ``plan(n_devices=1)``'s choice under NCCL at world
     size 1 on phase 7's model and batch (4 layers, bf16, AdamW, clip
     1.0), 2 + 4 steps: losses and final parameters equal the plain
     path's bit for bit, every training kernel launched; step time, peak
     memory and ``estimate_hbm`` over the measured peak; (c) phase 7's
     configuration at 1 layer (bf16 parameters, ≈2.5 GB) saved through
     the sharded save under the world-size-1 plan, then read onto the
     card by ``load_resharded(coords=)`` as every rank's slice under
     tp2, tp4, dp2_tp2 and fsdp4: each slice equal to ``shard_layer``'s
     cut of the same full tensor (``tp_slice``, FSDP2's row chunk) bit
     for bit; the read's seconds and GB/s.
 16. the native host runtime (``paddle_tpu_torch.native``, built with
     g++ from ``paddle_tpu_torch/csrc/pt_native.cc``; writing nothing to
     disk but /dev/shm's ring): 512 of phase 7's batches (2 x 4096
     tokens, seeded numpy rows) through ``DataLoader(num_workers=2,
     use_shared_memory=True)`` equal the ``num_workers=0`` batches and
     all came over the ShmRing (the loader's transport count); batches/s
     of both from the first batch's arrival (the seconds to it, the
     workers' spawn, apart); a spawned process answers through a TCPStore and pushes
     into a ShmRing (one round trip each); HostPool stats, a freed
     buffer reused.
 17. graph contracts (``paddle_tpu_torch.analysis``): (a) every
     single-process graph of the canonical registry (``analysis.graphs``:
     the micro Llama's train step K=1 / K=4, serving ticks native, int8
     and speculative, prefix admit, the fused CE head) on the card with
     the kernels, against the same budget file as the CPU
     (``tools/graph_budgets.json`` beside ``graph_lint``); each graph at 0
     host transfers once more under set_sync_debug_mode("error"); launch
     counts as the "graph_contracts" path; (b) inside phases 5 and 7, on
     their models: the census of one decode block of phase 5's 32-layer
     engine and of one step of phase 7's 4-layer trainer, each under
     set_sync_debug_mode("error"): no buffer of the vocabulary's width
     over 8192 rows, no host sync, every parameter, AdamW slot and KV
     pool written in place; (c) after 5e (whose window runs traced): the
     per-hop TTFT share (p50) of its stitched front-door traces, each
     request's share on named hops >= 0.95, and
     ``load_test.trace_overhead_legs`` over two replicas of 5d's settings
     (6 requests, 8 new tokens, 3 rounds). Any failure of (a)-(c) fails
     the run.
The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
TOL = {"float32": (1e-5, 1e-5),
       # bf16: the kernel and the plain version both compute in fp32 and
       # round once to bf16 (step 2**-8 relative); a different summation
       # order or FMA contraction before that rounding may land one bf16
       # step apart
       "bfloat16": (2e-2, 2e-2)}
# The bf16 flash kernels are held per row as well: a row is one head's
# d values of one query (out, dq) or key (dk, dv), and its error is
# |got - want|_2 / (|want|_2 + 1e-3 * the tensor's mean row norm). The
# elementwise bf16 limit above is as large as a typical flash value at
# s = 4096 (about 1/sqrt(context)), so alone it could pass a kernel that
# reads one K/V or Q tile in place of another; phase 3 plants such tiles
# and fails unless this check rejects them. Sound kernels read at most
# 8.1e-3 and planted tiles 0.35 or more (H100 80GB HBM3, 700 W). fp32
# needs no row check: its elementwise limit is far below any wrong
# tile's change.
ROW_TOL = 2e-2
# The vocab-CE kernels' lse and tgt are fp32 sums of exact products on
# both sides (bf16 or fp32 inputs), apart only in summation order: held
# to CE_FP32_TOL absolute, which sound kernels meet with margin and a
# planted wrong vocabulary block breaks by more than 10x (phase 3 prints
# both readings and fails otherwise). bf16 dh is held per row (one
# token's H values) and dW and dlog per column or row as the flash
# tensors are, with ROW_TOL.
CE_FP32_TOL = 1e-4
# Llama-3-8B's int8 projections of a decode step, (n, k)
DECODE_PROJECTIONS = {"qkv": (6144, 4096), "o": (4096, 4096),
                      "gate_up": (28672, 4096), "down": (4096, 14336),
                      "lm_head": (128256, 4096)}
CE_KERNELS = ("vocab_ce_fwd", "vocab_ce_dlog", "vocab_ce_dh", "vocab_ce_dw")
SERVING_KERNELS = ("rms_norm", "fused_rope", "paged_decode")
QUANT_SERVING_KERNELS = ("rms_norm", "fused_rope", "int8_matmul",
                         "paged_decode_int8")
TRAINING_KERNELS = ("rms_norm", "rms_norm_bwd", "fused_rope", "flash_fwd",
                    "flash_bwd") + CE_KERNELS
RESULTS: dict = {"kernel_cases": []}
ROOT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chiprun_out")
FAILED_CASES: list = []


def log(*a):
    print(*a, flush=True)


_MARK = [time.perf_counter()]


def mark(phase: str):
    """Log (and keep in RESULTS["phase_s"]) the seconds since the
    previous mark as ``phase``'s."""
    now = time.perf_counter()
    dt, _MARK[0] = now - _MARK[0], now
    RESULTS.setdefault("phase_s", {})[phase] = dt
    log(f"phase {phase}: {dt:.1f} s")


# device cycles (about 0.3 ms) that the card sleeps between the L2 flush
# and a timed launch, so that the host has enqueued the launch before
# the start event is reached: the events then measure the device alone,
# not a wrapper's host time (which exceeds the short kernels' own)
HOST_LEAD_CYCLES = 500_000


def timed_ms(torch, fn, flush, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` in ms, each launch timed
    alone by CUDA events after the L2 cache was flushed and the host was
    given a head start (HOST_LEAD_CYCLES)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def compare(torch, got, want, dtype_name):
    atol, rtol = TOL[dtype_name]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / w.abs().clamp_min(1e-6)).max())
    ok = bool((diff <= atol + rtol * w.abs()).all()) and bool(
        torch.isfinite(g).all())
    return max_abs, max_rel, ok


def row_err(torch, got, want) -> float:
    """The largest per-row relative L2 error of ``got`` (see ROW_TOL)."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    wn = w.norm(dim=-1)
    return float(((g - w).norm(dim=-1) / (wn + 1e-3 * wn.mean())).max())


def flash_compare(torch, pairs, dtype_name):
    """compare() over (got, want) pairs, combined, and the row check:
    (max_abs, max_rel, ok, row error, elementwise ok, row ok)."""
    errs = [compare(torch, g, w, dtype_name) for g, w in pairs]
    row = max(row_err(torch, g, w) for g, w in pairs)
    elem_ok = all(e[2] for e in errs)
    row_ok = dtype_name != "bfloat16" or row <= ROW_TOL
    return (max(e[0] for e in errs), max(e[1] for e in errs),
            elem_ok and row_ok, row, elem_ok, row_ok)


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def empty_cache(torch, dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# objects whose presence among collected garbage names the leg that left it
CYCLE_OWNERS = ("Trainer", "ContinuousBatchingEngine", "ServingFabric",
                "FrontDoor", "LlamaForCausalLM", "MoEForCausalLM")
# the card memory a full collection may free before the leg fails: more
# means an earlier phase left a model, an engine's pool or a trainer in
# a reference cycle (a relayed error's traceback once pinned 5e's
# engines and their model: 19 GiB)
CYCLE_BOUND_BYTES = 1 << 30


def collect_cycles(torch, dev, where):
    """A full collection before a leg that needs the card to itself, and
    the check that earlier phases left nothing on the card in reference
    cycles (a frame pinned through a traceback, a closure), which only
    the collector's next full pass would free, at a time that depends on
    every object the process made. Returns, and logs, the card memory it
    freed and the owners (CYCLE_OWNERS, and frames by function) among
    the freed objects; fails when it freed more than CYCLE_BOUND_BYTES."""
    import gc
    cuda = dev.type == "cuda"
    before = torch.cuda.memory_allocated(dev) if cuda else 0
    owners: dict = {}
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
        for o in gc.garbage:
            name = type(o).__name__
            if name == "frame":
                name = f"frame {o.f_code.co_name}"
            elif name not in CYCLE_OWNERS:
                continue
            owners[name] = owners.get(name, 0) + 1
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    gc.collect()
    empty_cache(torch, dev)
    freed = before - (torch.cuda.memory_allocated(dev) if cuda else 0)
    top = dict(sorted(owners.items(), key=lambda kv: -kv[1])[:12])
    log(f"{where}: a full collection freed {freed / 2**30:.3f} GiB of card "
        f"memory held by reference cycles (bound "
        f"{CYCLE_BOUND_BYTES / 2**30:.3f} GiB); owners among the freed "
        f"objects {top}")
    if freed > CYCLE_BOUND_BYTES:
        raise SystemExit(f"{where}: earlier phases left "
                         f"{freed / 2**30:.3f} GiB of card memory in "
                         f"reference cycles (owners {top})")
    return {"freed_bytes": freed, "owners": top}


class DeviceSpan:
    """Milliseconds from construction to :meth:`end`: CUDA events on the
    card (device time), the host clock after the work on the CPU."""

    def __init__(self, torch, dev):
        self.cuda = dev.type == "cuda"
        self.t0 = time.perf_counter()
        if self.cuda:
            self.s = torch.cuda.Event(enable_timing=True)
            self.e = torch.cuda.Event(enable_timing=True)
            self.s.record()

    def stop(self) -> "DeviceSpan":
        """Mark the end without waiting for the device."""
        self.t1 = time.perf_counter()
        if self.cuda:
            self.e.record()
        return self

    def ms(self) -> float:
        """The span's milliseconds, once its end is reached."""
        if not self.cuda:
            return (self.t1 - self.t0) * 1e3
        self.e.synchronize()
        return self.s.elapsed_time(self.e)

    def end(self) -> float:
        return self.stop().ms()


def profile_step(torch, dev, step, top=8, sums=None):
    """The device's activity over one call of ``step``, from a
    torch.profiler (CUPTI) trace of the device alone: no CPU op is
    recorded, so the host runs near its own pace, and the kineto events
    are read as they come, without the profiler's event tree (which
    takes minutes over a call of ~10^5 launches). Busy ms is the union
    of the kernels' and copies' intervals; by kernel name, the device ms
    and launches. ``sums`` {label: name fragments}: also the summed
    device us and launches of the kernels whose names hold a fragment.
    None off the card or where no device time is reported."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    sync(torch, dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        sync(torch, dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [(e.name(), e.start_ns(), e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA
              and e.duration_ns() > 0]
    if not events:
        return None
    per = {}
    for name, _, ns in events:
        ms, n = per.get(name, (0.0, 0))
        per[name] = (ms + ns / 1e6, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in per.items()),
                  key=lambda r: -r[1])
    spans = sorted((t, t + ns) for _, t, ns in events)
    busy, (lo, hi) = 0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy = (busy + hi - lo) / 1e6
    summed = {label: {"us": sum(r[1] for r in rows if any(
        f in r[0] for f in frags)) * 1e3, "launches": sum(
        r[2] for r in rows if any(f in r[0] for f in frags))}
        for label, frags in (sums or {}).items()}
    return {"wall_ms_under_profiler": wall_ms, "device_busy_ms": busy,
            "sums": summed,
            "device_idle_share": 1.0 - busy / wall_ms,
            "kernels": len(rows),
            "launches": len(events),
            "top": [{"name": k[:90], "ms": ms, "count": n}
                    for k, ms, n in rows[:top]]}   # top=None: every kernel


def bound(bytes_, ops, ops_per_s=FP32_OPS_PER_S):
    tb, to = bytes_ / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def us(ms):
    return "-" if ms is None else f"{ms * 1e3:.1f} us"


def record(kernel, case, dt, err, kms=None, pms=None, lms=None,
           bnd=(None, None), tol=None, copy_ms=None):
    """One checked case; the times are None for a case checked only.
    ``err`` is compare()'s triple, or flash_compare()'s six-tuple;
    ``tol`` overrides the printed elementwise tolerance TOL[dt];
    ``copy_ms`` is a streaming copy of the kernel's bytes (read and
    write), timed the same way, where one is kept."""
    max_abs, max_rel, ok = err[:3]
    tol = TOL[dt] if tol is None else tol
    row = dict(kernel=kernel, case=case, dtype=dt, max_abs_err=max_abs,
               max_rel_err=max_rel, tol=tol, ok=ok, ms=kms,
               plain_ms=pms, library_ms=lms, bound_ms=bnd[0],
               bound_by=bnd[1], copy_ms=copy_ms)
    rows = ""
    if len(err) > 3:
        tol = ROW_TOL if dt == "bfloat16" else None
        row.update(row_err=err[3], row_tol=tol)
        rows = f" row_err={err[3]:.3e} row_tol={tol}"
    RESULTS["kernel_cases"].append(row)
    timing = ("not timed" if kms is None else
              f"kernel {us(kms)}, plain {us(pms)}, library {us(lms)}, "
              f"bound {bnd[0] * 1e3:.2f} us ({bnd[1]})"
              + ("" if copy_ms is None else f", copy {us(copy_ms)}"))
    log(f"kernel {kernel} [{case} {dt}] max_abs_err={max_abs:.3e} "
        f"max_rel_err={max_rel:.3e} tol(atol,rtol)={tol}{rows} "
        f"{'ok' if ok else 'FAIL'} | {timing}")
    if not ok:
        FAILED_CASES.append(f"{kernel}/{case}/{dt}")


# The RMSNorm and RoPE forwards' rows: (case, rows, width) and (case,
# (b, s), (q heads, kv heads)); decode, prefill, a speculative verify
# (B = 8, spec_k = 4: 5 tokens a row) and a 512-token prefill chunk at
# Llama-3-8B's widths, training at Llama-3-8B's and DeepSeekMoE-16B's
# (the MoE slice trains only)
NORM_CASES = (("prefill_1024", 1024, 4096), ("decode_b8", 8, 4096),
              ("verify_b8x5", 40, 4096), ("chunk_512", 512, 4096),
              ("train_8192", 8192, 4096), ("train_8192_moe", 8192, 2048))
ROPE_CASES = (("prefill_1024", (1, 1024), (32, 8)),
              ("decode_b8", (8, 1), (32, 8)),
              ("verify_b8x5", (8, 5), (32, 8)),
              ("chunk_512", (1, 512), (32, 8)),
              ("train_4096", (2, 4096), (32, 8)),
              ("train_4096_moe", (2, 4096), (16, 16)))
# the profiler's kernel names of the RMSNorm forward and RoPE routes
NORM_ROPE_KERNELS = {"rms_norm": ("rms_norm_row_kernel",
                                  "rms_norm_vec_kernel"),
                     "fused_rope": ("rope_vec_kernel", "rope_scalar_kernel")}
# rstd is fp32 on both sides, apart only in summation order
RSTD_TOL = 1e-5


def rope_positions(torch, g, dev, case, b, s, table=8192):
    """The positions a RoPE row is called with: none for prefill and
    training (0 .. s - 1); at decode one random position a row; a chunk's
    s .. 2 s - 1 (the second chunk of a prompt); at verify s consecutive
    positions a row from a random start, row 0 from table - 2, so that
    its last three run past the ``table``-row cos/sin tables (clamped to
    the last row, as a JAX gather clamps)."""
    if case.startswith(("prefill", "train")):
        return None
    if case.startswith("chunk"):
        return (torch.arange(s, device=dev) + s)[None].expand(
            b, s).contiguous()
    if s == 1:
        return torch.randint(0, 2048, (b, s), generator=g, device=dev)
    start = torch.randint(0, 2048, (b, 1), generator=g, device=dev)
    start[0] = table - 2
    return start + torch.arange(s, device=dev)[None]


def norm_err(torch, got, want, dtype_name):
    """compare() of the RMSNorm forward's y (the dtype's tolerance) and
    rstd (RSTD_TOL), combined: (max_abs, max_rel, ok)."""
    ey = compare(torch, got[0], want[0], dtype_name)
    diff = (got[1] - want[1]).abs()
    er = (float(diff.max()), float((diff / want[1].abs()).max()),
          bool((diff <= RSTD_TOL * (1 + want[1].abs())).all()))
    return max(ey[0], er[0]), max(ey[1], er[1]), ey[2] and er[2]


def planted_norm_vector(torch, fused_norm, x, w, eps, want):
    """The RMSNorm forward run as if it had dropped the last 16-byte
    vector of row 3 (those 8 inputs zeroed): the row check (y and rstd)
    must reject it. Both readings are kept."""
    bad = x.clone()
    bad[3, -8:] = 0
    got = fused_norm.rms_norm_fwd(bad, w, eps, return_rstd=True)
    y_err = compare(torch, got[0], want[0], "bfloat16")
    rstd_err = float(((got[1] - want[1]).abs() / want[1].abs()).max())
    err = norm_err(torch, got, want, "bfloat16")
    RESULTS["planted_norm_vector"] = {"y_max_abs": y_err[0],
                                      "rstd_max_rel": rstd_err,
                                      "rejected": not err[2]}
    log(f"planted RMSNorm fault (last vector of row 3 dropped): y max abs "
        f"{y_err[0]:.3e}, rstd max rel {rstd_err:.3e} (limit {RSTD_TOL}): "
        f"{'rejected' if not err[2] else 'NOT rejected'}")
    if err[2]:
        FAILED_CASES.append("rms_norm/planted_vector_not_rejected")


def planted_rope_position(torch, fused_rope, q, k, cos, sin, pos, want):
    """RoPE at decode run with every position one too far: the check must
    reject it."""
    got = fused_rope.fused_rope(q, k, cos, sin, pos + 1)
    errs = [compare(torch, a, b, "bfloat16") for a, b in zip(got, want)]
    ok = all(e[2] for e in errs)
    RESULTS["planted_rope_position"] = {
        "max_abs": max(e[0] for e in errs), "rejected": not ok}
    log(f"planted RoPE fault (positions off by one): max abs "
        f"{max(e[0] for e in errs):.3e}: "
        f"{'rejected' if not ok else 'NOT rejected'}")
    if ok:
        FAILED_CASES.append("fused_rope/planted_position_not_rejected")


def norm_rope_plan_sweep(torch, dev, g, cos, sin, flush):
    """With ``--sweep``: the RMSNorm forward and RoPE under other plan
    constants, at phase 3's bf16 shapes, each timed as the rows are (us)
    and held bit for bit to the default plan's output (a plan changes no
    arithmetic)."""
    from paddle_tpu_torch.ops.kernels import fused_norm, fused_rope
    rows = {}

    def sweep(label, mod, settings, fn, want):
        saved = {k: getattr(mod, k) for k in settings}
        try:
            for k, v in settings.items():
                setattr(mod, k, v)
            got = fn()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            us_ = timed_ms(torch, fn, flush) * 1e3
        finally:
            for k, v in saved.items():
                setattr(mod, k, v)
        rows[label] = {"us": us_, "bit_equal": same}
        if not same:
            FAILED_CASES.append(f"plan_sweep/{label}_not_bit_equal")
        return us_
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for case, R, width in NORM_CASES:
        x = torch.randn((R, width), generator=g, device=dev).to(
            torch.bfloat16)
        w = 1 + 0.1 * torch.randn((width,), generator=g, device=dev)

        def norm(x=x, w=w):
            return fused_norm.rms_norm_fwd(x, w, 1e-5, return_rstd=True)
        want = norm()
        for bps in ((2,) if R <= sms else (1, 2, 3, 4)):
            sweep(f"rms_norm/{case}/blocks_per_sm{bps}", fused_norm,
                  {"BLOCKS_PER_SM": bps}, norm, want)
    for case, (b, s), (h, hkv) in ROPE_CASES:
        qkv = torch.randn((b, s, (h + 2 * hkv) * 128), generator=g,
                          device=dev).to(torch.bfloat16)
        q = qkv[..., :h * 128].view(b, s, h, 128)
        k = qkv[..., h * 128:(h + hkv) * 128].view(b, s, hkv, 128)
        pos = rope_positions(torch, g, dev, case, b, s)

        def rope(q=q, k=k, pos=pos):
            return fused_rope.fused_rope(q, k, cos, sin, pos)
        want = rope()
        for threads in (64, 128, 256):
            for min_t in (256, 1024, 4096):
                for bps in (4, 16):
                    sweep(f"fused_rope/{case}/threads{threads}/"
                          f"min_threads{min_t}/blocks_per_sm{bps}",
                          fused_rope, {"THREADS": threads,
                                       "MIN_THREADS_PER_SM": min_t,
                                       "BLOCKS_PER_SM": bps}, rope, want)
    RESULTS["norm_rope_plan_sweep"] = rows
    best = {}
    for label, row in rows.items():
        kernel, case = label.split("/")[:2]
        key = f"{kernel}/{case}"
        if key not in best or row["us"] < best[key][1]:
            best[key] = (label, row["us"])
    for key, (label, us_) in best.items():
        log(f"plan sweep, fastest {key}: {label} {us_:.2f} us")


def phase_kernels(torch, pt):
    from paddle_tpu_torch.ops import attention as attn_ops
    from paddle_tpu_torch.ops import norm as norm_ops
    from paddle_tpu_torch.ops import rope as rope_ops
    from paddle_tpu_torch.ops.kernels import fused_norm, fused_rope
    from paddle_tpu_torch.ops.kernels import paged_attention
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    H, HKV, HD = 32, 8, 128
    cos, sin = rope_ops.rope_freqs(HD, 8192, 500000.0, device=dev)

    # -- the launch floor: an empty kernel, timed as every row is --------
    from paddle_tpu_torch.ops.kernels import _build
    stream = _build.stream_ptr(dev)
    floor_ms = timed_ms(torch, lambda: _build.check(
        _build.lib().pt_empty(stream), "empty kernel"), flush)
    RESULTS["launch_floor_us"] = floor_ms * 1e3
    log(f"launch floor (an empty kernel, timed as every row): "
        f"{floor_ms * 1e3:.2f} us")

    # -- RMSNorm: prefill 1024 tokens, decode B=8, a training step's
    # 2 x 4096 tokens at Llama's width and at DeepSeekMoE's, fp32 weight;
    # y within the dtype's tolerance and rstd within 1e-5 -------------------
    for case, R, width in NORM_CASES:
        for dt in ((torch.bfloat16, torch.float32) if R == 1024
                   else (torch.bfloat16,)):
            name = str(dt).split(".")[-1]
            x = torch.randn((R, width), generator=g, device=dev).to(dt)
            w = (1 + 0.1 * torch.randn((width,), generator=g, device=dev))
            eps = 1e-5
            want = norm_ops._rms_norm_fwd_plain(x, w, eps)
            err = norm_err(torch, fused_norm.rms_norm_fwd(
                x, w, eps, return_rstd=True), want, name)
            if case == "decode_b8" and dt == torch.bfloat16:
                planted_norm_vector(torch, fused_norm, x, w, eps, want)
            wl = w.to(dt)
            e = x.element_size()
            dst = torch.empty_like(x)
            record("rms_norm", case, name, err,
                   timed_ms(torch, lambda: fused_norm.rms_norm_fwd(
                       x, w, eps), flush),
                   timed_ms(torch, lambda: norm_ops._rms_norm_plain(
                       x, w, eps), flush),
                   timed_ms(torch, lambda: F.rms_norm(x, (width,), wl,
                                                      eps), flush),
                   bound(2 * R * width * e + width * 4, 4 * R * width),
                   copy_ms=timed_ms(torch, lambda: dst.copy_(x), flush))

    # -- RoPE: prefill and training q/k as views of a fused qkv (Llama's
    # heads, and DeepSeekMoE's 16/16 in training), decode with positions
    # -----------------------------------------------------------------------
    for case, (b, s), (h, hkv) in ROPE_CASES:
        for dt in ((torch.bfloat16, torch.float32) if s == 1024
                   else (torch.bfloat16,)):
            name = str(dt).split(".")[-1]
            qkv = torch.randn((b, s, (h + 2 * hkv) * HD), generator=g,
                              device=dev).to(dt)
            q = qkv[..., :h * HD].view(b, s, h, HD)
            k = qkv[..., h * HD:(h + hkv) * HD].view(b, s, hkv, HD)
            pos = rope_positions(torch, g, dev, case, b, s)
            gq, gk = fused_rope.fused_rope(q, k, cos, sin, pos)
            wq, wk = rope_ops._rope_plain(q, k, cos, sin, pos)
            ea = compare(torch, gq, wq, name)
            eb = compare(torch, gk, wk, name)
            err = (max(ea[0], eb[0]), max(ea[1], eb[1]), ea[2] and eb[2])
            if case == "decode_b8" and dt == torch.bfloat16:
                planted_rope_position(torch, fused_rope, q, k, cos, sin,
                                      pos, (wq, wk))
            e = q.element_size()
            nbytes = 2 * b * s * (h + hkv) * HD * e + 2 * b * s * HD * 4
            src = torch.empty((b, s, h + hkv, HD), dtype=dt, device=dev)
            dst = torch.empty_like(src)
            record("fused_rope", case, name, err,
                   timed_ms(torch, lambda: fused_rope.fused_rope(
                       q, k, cos, sin, pos), flush),
                   timed_ms(torch, lambda: rope_ops._rope_plain(
                       q, k, cos, sin, pos), flush),
                   None, bound(nbytes, 3 * b * s * (h + hkv) * HD),
                   copy_ms=timed_ms(torch, lambda: dst.copy_(src), flush))
    if "--sweep" in sys.argv:
        norm_rope_plan_sweep(torch, dev, g, cos, sin, flush)

    # -- paged decode: B=8, page 128, context 1024 -------------------------
    B, page, ctx = 8, 128, 1024
    mp = 2048 // page
    num_pages = B * mp + 1
    for case in ("ctx1024", "ragged"):
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            q = torch.randn((B, H, HD), generator=g, device=dev).to(dt)
            kp = torch.randn((HKV, num_pages, page, HD), generator=g,
                             device=dev).to(dt)
            vp = torch.randn((HKV, num_pages, page, HD), generator=g,
                             device=dev).to(dt)
            perm = torch.randperm(num_pages - 1, generator=g,
                                  device=dev)[:B * mp] + 1
            tables = perm.view(B, mp).to(torch.int32).contiguous()
            if case == "ctx1024":
                lens = torch.full((B,), ctx - 1, dtype=torch.int64,
                                  device=dev)
            else:
                lens = torch.randint(0, 2048, (B,), generator=g,
                                     device=dev)
                lens[0], lens[1] = 0, page - 1
                used = (lens // page + 1)[:, None]
                col = torch.arange(mp, device=dev)[None, :]
                tables = torch.where(col < used, tables,
                                     torch.full_like(tables, -1))
            got = paged_attention.paged_decode(q, kp, vp, tables, lens)
            want = attn_ops.paged_decode_plain(q, kp, vp, tables, lens)
            err = flash_compare(torch, [(got, want)], name)
            if case != "ctx1024":
                record("paged_decode", case, name, err)
                continue
            if dt == torch.bfloat16:
                planted_page(torch, paged_attention, q, kp, vp, tables,
                             lens, want, name)
                paged_sweep(torch, paged_attention, "paged_decode", q, kp,
                            vp, tables, {}, flush)
            # library yardstick: SDPA over the K/V gathered beforehand
            # (gather not timed; the port never calls SDPA)
            safe = tables.long()[:, :ctx // page]
            kg = kp[:, safe].reshape(HKV, B, ctx, HD).transpose(0, 1)
            vg = vp[:, safe].reshape(HKV, B, ctx, HD).transpose(0, 1)
            kg = kg.repeat_interleave(H // HKV, 1).contiguous()
            vg = vg.repeat_interleave(H // HKV, 1).contiguous()
            q4 = q[:, :, None, :]
            e = q.element_size()
            nbytes = (2 * B * H * HD * e + 2 * B * HKV * ctx * HD * e
                      + tables.numel() * 4 + B * 8)
            record("paged_decode", case, name, err,
                   timed_ms(torch, lambda: paged_attention.paged_decode(
                       q, kp, vp, tables, lens), flush),
                   timed_ms(torch, lambda: attn_ops.paged_decode_plain(
                       q, kp, vp, tables, lens), flush),
                   timed_ms(torch, lambda: F.scaled_dot_product_attention(
                       q4, kg, vg), flush),
                   bound(nbytes, 4 * B * H * ctx * HD))
    del flush
    torch.cuda.synchronize()


def planted_page(torch, paged_attention, q, kp, vp, tables, lens, want,
                 name):
    """Run the native paged decode as if row 0's table read its page 5
    in place of its page 3 (a wrong page lookup) and hold the result
    against the plain version of the true table: the row check must
    reject it (one eighth of the context's K and V is another page's)."""
    bad = tables.clone()
    bad[0, 3] = tables[0, 5]
    e = flash_compare(torch, [(paged_attention.paged_decode(
        q, kp, vp, bad, lens), want)], name)
    RESULTS.setdefault("planted_paged", {})["paged_decode/page"] = {
        "row_err": e[3], "row_caught": not e[5], "max_abs_err": e[0]}
    log(f"planted page in paged_decode (row 0 reads its page 5 as page 3): "
        f"max_abs_err={e[0]:.3e}, row_err={e[3]:.3e} vs row_tol {ROW_TOL} "
        f"(row check {'rejects' if not e[5] else 'MISSES'} it)")
    if e[5]:
        FAILED_CASES.append("paged_decode/planted_page_missed")


def paged_sweep(torch, paged_attention, kernel, q, kp, vp, tables, sc,
                flush):
    """The paged decode kernel's time at contexts 128, 512, 1024 and 2048
    (B = 8, the ctx1024 case's pools and tables), each beside one
    streaming read of as many bytes as its K and V (one torch sum over
    an fp32 buffer of that size, under the same L2 flush): the yardstick
    of what reading those bytes costs in this timing."""
    B, HD = q.shape[0], q.shape[2]
    HKV = kp.shape[0]
    ctxs = (128, 512, 1024, 2048)
    per_tok = 2 * B * HKV * HD * kp.element_size()   # K and V bytes a token
    buf = torch.zeros((per_tok * ctxs[-1] // 4,), dtype=torch.float32,
                      device=q.device)
    rows = {}
    for ctx in ctxs:
        lens = torch.full((B,), ctx - 1, dtype=torch.int64, device=q.device)
        n = per_tok * ctx
        flat = buf[:n // 4]
        rows[ctx] = {
            "kernel_ms": timed_ms(torch, lambda: paged_attention.paged_decode(
                q, kp, vp, tables, lens, **sc), flush),
            "stream_read_ms": timed_ms(torch, lambda: flat.sum(), flush),
            "kv_bytes": n}
        log(f"kernel {kernel} sweep [ctx {ctx}]: {us(rows[ctx]['kernel_ms'])}"
            f", a streaming read of its {n / 1e6:.1f} MB "
            f"{us(rows[ctx]['stream_read_ms'])}")
    RESULTS.setdefault("paged_decode_sweep", {})[kernel] = rows


def seg_err(torch, got, want) -> float:
    """row_err() over 128-wide segments of each output row: a row of the
    int8 product is n columns (up to 128256), where one wrong block of
    64 would hide, so each token's output is held 128 columns at a time,
    the length of a flash row."""
    return row_err(torch, got.float().reshape(-1, 128),
                   want.float().reshape(-1, 128))


def int8_compare(torch, got, want, dtype_name):
    """flash_compare()'s six-tuple for the int8 product: elementwise, and
    for bf16 the 128-column segment check (seg_err) against ROW_TOL."""
    e = compare(torch, got, want, dtype_name)
    seg = seg_err(torch, got, want)
    row_ok = dtype_name != "bfloat16" or seg <= ROW_TOL
    return e[0], e[1], e[2] and row_ok, seg, e[2], row_ok


def int8_decode_plan_sweep(torch, g, dev, flush):
    """The int8 decode route at the five projections (m = 8, bf16) under
    other split plans than the default: the plan's cap on blocks an SM
    (BLOCKS_PER_SM) and on a split's k (SPLIT_K_MAX), each plan's output
    held to the plain version, its time as phase 3's."""
    from paddle_tpu_torch.nn.quantized_linear import weight_quantize
    from paddle_tpu_torch.ops import quant as quant_ops
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import int8_matmul as kmm
    default = (kmm.BLOCKS_PER_SM, kmm.SPLIT_K_MAX)
    sms = _build.sm_count(dev)
    rows = {}
    for proj, (n, k) in DECODE_PROJECTIONS.items():
        wq, scale = weight_quantize(0.02 * torch.randn(
            (k, n), generator=g, device=dev))
        x = torch.randn((8, k), generator=g, device=dev).to(torch.bfloat16)
        want = quant_ops.weight_only_plain(x, wq, scale)
        for bps in (1.5, 2.5, 4):
            for kmax in (2048, 4096):
                kmm.BLOCKS_PER_SM, kmm.SPLIT_K_MAX = bps, kmax
                try:
                    err = int8_compare(torch, kmm.int8_matmul(x, wq, scale),
                                       want, "bfloat16")
                    ms = timed_ms(torch, lambda: kmm.int8_matmul(
                        x, wq, scale), flush)
                    plan = kmm.split_plan(8, n, k, sms)
                finally:
                    kmm.BLOCKS_PER_SM, kmm.SPLIT_K_MAX = default
                rows[f"{proj}/bps{bps}/kmax{kmax}"] = {
                    "us": ms * 1e3, "kps": plan[0], "splits": plan[1],
                    "ok": err[2]}
                log(f"int8 decode plan [{proj}, {bps} blocks an SM, splits "
                    f"of at most {kmax} k]: kps {plan[0]}, {plan[1]} "
                    f"splits, {ms * 1e3:.1f} us, "
                    f"{'ok' if err[2] else 'FAIL'}")
                if not err[2]:
                    FAILED_CASES.append(f"int8_matmul/plan_{proj}_{bps}_"
                                        f"{kmax}")
        del wq, scale, x, want
    RESULTS["int8_decode_plan_sweep"] = rows
    torch.cuda.synchronize()


def quant_pages(torch, g, dev, hkv, num_pages, page, hd):
    """Int8 page pools as the model writes them: float pages of varied
    magnitudes (a factor from 0.25 to 4 a page), one absmax scale a
    page, round-half-to-even codes. Returns (codes, scales)."""
    f = torch.randn((hkv, num_pages, page, hd), generator=g, device=dev)
    f *= 0.25 * 16 ** torch.rand((1, num_pages, 1, 1), generator=g,
                                 device=dev)
    s = f.abs().amax(dim=(0, 2, 3)) / 127.0
    codes = torch.round(f / s[None, :, None, None]).clamp_(-127, 127)
    return codes.to(torch.int8), s


def phase_quant_kernels(torch, pt):
    """Phase 3, the quantized-serving kernels. int8_matmul at the five
    projections of a Llama-3-8B decode step (m = 8, bf16; each beside a
    streaming read of its weight's bytes), at gate_up with m = 128 and
    1024 (prefills) and in fp32 at a small ragged shape (m = 5, n = 384,
    k = 256), with planted faults at qkv, at down (k split) and at the
    prefill, and the decode route's plan sweep; the int8 paged decode at
    B = 8, context 1024, page 128 (bf16 and fp32 q, and a ragged case),
    with planted page scales."""
    from paddle_tpu_torch.nn.quantized_linear import weight_quantize
    from paddle_tpu_torch.ops import attention as attn_ops
    from paddle_tpu_torch.ops import quant as quant_ops
    from paddle_tpu_torch.ops.kernels import int8_matmul as kmm
    from paddle_tpu_torch.ops.kernels import paged_attention
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2468)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    planted = {}

    def mm_case(case, m, n, k, dt, timed=True, plant=False, read=None):
        name = str(dt).split(".")[-1]
        wq, scale = weight_quantize(0.02 * torch.randn(
            (k, n), generator=g, device=dev))
        x = torch.randn((m, k), generator=g, device=dev).to(dt)
        got = kmm.int8_matmul(x, wq, scale)
        want = quant_ops.weight_only_plain(x, wq, scale)
        err = int8_compare(torch, got, want, name)
        t = (None, None, None)
        bnd = (None, None)
        if timed:
            # the yardstick: one torch.matmul with the bf16 weight of the
            # same [k, n] shape, as the native model runs (twice the
            # weight bytes of the int8 product)
            wbf = (wq.float() * scale[:, None]).t().contiguous().to(dt)
            t = (timed_ms(torch, lambda: kmm.int8_matmul(x, wq, scale),
                          flush),
                 timed_ms(torch, lambda: quant_ops.weight_only_plain(
                     x, wq, scale), flush, reps=10),
                 timed_ms(torch, lambda: torch.matmul(x, wbf), flush))
            e = x.element_size()
            bnd = bound(m * k * e + n * k + 4 * n + m * n * e, 2 * m * n * k,
                        BF16_OPS_PER_S if dt == torch.bfloat16
                        else FP32_OPS_PER_S)
            del wbf
        record("int8_matmul", case, name, err, *t, bnd)
        if read is not None:
            # the yardstick of what reading the weight's bytes costs in
            # this timing: one torch sum over an fp32 buffer of n k bytes,
            # under the same L2 flush
            flat = read[:n * k // 4]
            rd = timed_ms(torch, lambda: flat.sum(), flush)
            RESULTS.setdefault("int8_decode_stream_read", {})[case] = {
                "kernel_ms": t[0], "stream_read_ms": rd, "bound_ms": bnd[0],
                "weight_bytes": n * k}
            log(f"kernel int8_matmul [{case}]: {us(t[0])}, a streaming "
                f"read of its {n * k / 1e6:.1f} MB weight {us(rd)}")
        if timed and m > 16:
            product_rate("int8_matmul", case, 2 * m * n * k, bnd, t[0], t[2],
                    key="gemm_rates")
        if plant:
            # (a) the weight's 64-wide k-block 7 swapped with block 8;
            # (b) the scales of channels 1024..1087 taken from the next
            # 64 channels
            w2 = wq.clone()
            w2[:, 448:512], w2[:, 512:576] = wq[:, 512:576], wq[:, 448:512]
            s2 = scale.clone()
            s2[1024:1088] = scale[1088:1152]
            for what, args in (("k_block_swapped", (x, w2, scale)),
                               ("scale_block_shifted", (x, wq, s2))):
                e = int8_compare(torch, kmm.int8_matmul(*args), want,
                                 name)
                planted[f"{case}/{what}"] = {"seg_err": e[3],
                                             "row_caught": not e[5],
                                             "max_abs_err": e[0]}
                log(f"planted fault in int8_matmul [{case}] ({what}): "
                    f"max_abs_err={e[0]:.3e}, row_err={e[3]:.3e} vs row_tol "
                    f"{ROW_TOL} (row check "
                    f"{'rejects' if not e[5] else 'MISSES'} it)")
                if e[5]:
                    FAILED_CASES.append(f"int8_matmul/{case}/{what}_missed")
        torch.cuda.synchronize()

    read = torch.zeros((max(n * k for n, k in DECODE_PROJECTIONS.values())
                        // 4,), dtype=torch.float32, device=dev)
    for proj, (n, k) in DECODE_PROJECTIONS.items():
        mm_case(f"decode_{proj}", 8, n, k, torch.bfloat16,
                plant=proj in ("qkv", "down"), read=read)
    del read
    int8_decode_plan_sweep(torch, g, dev, flush)
    # prefill: the serving run's shortest prompt and a long one
    mm_case("prefill_gate_up_128", 128, 28672, 4096, torch.bfloat16)
    mm_case("prefill_gate_up_1024", 1024, 28672, 4096, torch.bfloat16,
            plant=True)
    # the feature runs' products: a speculative verify at B = 8, spec_k =
    # 4 (m = 40) at each projection, and a 512-token prefill chunk
    for proj, (n, k) in DECODE_PROJECTIONS.items():
        mm_case(f"verify_{proj}_40", 40, n, k, torch.bfloat16,
                plant=proj in ("qkv", "down"))
    for proj in ("qkv", "o", "gate_up", "down"):
        n, k = DECODE_PROJECTIONS[proj]
        mm_case(f"chunk_{proj}_512", 512, n, k, torch.bfloat16,
                plant=proj == "gate_up")
    mm_case("ragged_5x384x256", 5, 384, 256, torch.float32, timed=False)
    torch.cuda.empty_cache()

    # -- int8 paged decode: B=8, page 128, context 1024 ---------------------
    B, H, HKV, HD, page, ctx = 8, 32, 8, 128, 128, 1024
    mp = 2048 // page
    num_pages = B * mp + 1
    kp, ks = quant_pages(torch, g, dev, HKV, num_pages, page, HD)
    vp, vs = quant_pages(torch, g, dev, HKV, num_pages, page, HD)
    for case in ("ctx1024", "ragged"):
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            q = torch.randn((B, H, HD), generator=g, device=dev).to(dt)
            perm = torch.randperm(num_pages - 1, generator=g,
                                  device=dev)[:B * mp] + 1
            tables = perm.view(B, mp).to(torch.int32).contiguous()
            if case == "ctx1024":
                lens = torch.full((B,), ctx - 1, dtype=torch.int64,
                                  device=dev)
            else:
                lens = torch.randint(0, 2048, (B,), generator=g,
                                     device=dev)
                lens[0], lens[1] = 0, page - 1
                used = (lens // page + 1)[:, None]
                col = torch.arange(mp, device=dev)[None, :]
                tables = torch.where(col < used, tables,
                                     torch.full_like(tables, -1))
                ks[tables[2, 0]] = 0.0          # a page never written
            sc = dict(k_scales=ks, v_scales=vs)
            got = paged_attention.paged_decode(q, kp, vp, tables, lens,
                                               **sc)
            want = attn_ops.paged_decode_plain(q, kp, vp, tables, lens,
                                               **sc)
            err = flash_compare(torch, [(got, want)], name)
            if case != "ctx1024" or dt != torch.bfloat16:
                record("paged_decode_int8", case, name, err)
                continue
            # library yardstick: SDPA over K/V dequantized and gathered
            # beforehand (not timed; the port never calls SDPA)
            safe = tables.long()[:, :ctx // page]

            def deq(pages, s):
                x = pages[:, safe].float() * s[safe][None, :, :, None, None]
                x = x.reshape(HKV, B, ctx, HD).transpose(0, 1)
                return x.repeat_interleave(H // HKV, 1).to(dt).contiguous()
            kg, vg = deq(kp, ks), deq(vp, vs)
            q4 = q[:, :, None, :]
            e = q.element_size()
            nbytes = (2 * B * H * HD * e + 2 * B * HKV * ctx * HD
                      + 2 * B * (ctx // page) * 4 + tables.numel() * 4
                      + B * 8)
            record("paged_decode_int8", case, name, err,
                   timed_ms(torch, lambda: paged_attention.paged_decode(
                       q, kp, vp, tables, lens, **sc), flush),
                   timed_ms(torch, lambda: attn_ops.paged_decode_plain(
                       q, kp, vp, tables, lens, **sc), flush),
                   timed_ms(torch, lambda: F.scaled_dot_product_attention(
                       q4, kg, vg), flush),
                   bound(nbytes, 4 * B * H * ctx * HD))
            del kg, vg
            paged_sweep(torch, paged_attention, "paged_decode_int8", q, kp,
                        vp, tables, sc, flush)
            # planted: row 0's page of the largest K scale (the page its
            # attention weighs most) read with the K (V) scale of the page
            # of row 0 whose K (V) scale differs most from its own
            row0 = tables[0, :ctx // page].long()
            p0 = row0[ks[row0].argmax()]
            for what, kw in (("k_scale", "k_scales"),
                             ("v_scale", "v_scales")):
                s0 = sc[kw]
                other = row0[(s0[row0] / s0[p0]).log().abs().argmax()]
                bad = dict(sc)
                bad[kw] = sc[kw].clone()
                bad[kw][p0] = sc[kw][other]
                e2 = flash_compare(torch, [(paged_attention.paged_decode(
                    q, kp, vp, tables, lens, **bad), want)], name)
                planted[f"paged_decode_int8/{what}"] = {
                    "row_err": e2[3], "row_caught": not e2[5],
                    "max_abs_err": e2[0]}
                log(f"planted page scale in paged_decode_int8 ({what} of "
                    f"page {int(p0)} from page {int(other)}): max_abs_err="
                    f"{e2[0]:.3e}, row_err={e2[3]:.3e} vs row_tol {ROW_TOL} "
                    f"(row check {'rejects' if not e2[5] else 'MISSES'} it)")
                if e2[5]:
                    FAILED_CASES.append(f"paged_decode_int8/{what}_missed")
    RESULTS["planted_quant"] = planted
    del flush, kp, vp
    torch.cuda.empty_cache()


def phase_train_kernels(torch, pt):
    """Phase 3, training kernels: the RMSNorm backward, the RoPE
    backward's table and the flash forward and backward against their
    plain versions at the training path's shapes. Runs with autograd on,
    for the library backward calls."""
    from paddle_tpu_torch.ops import attention as attn_ops
    from paddle_tpu_torch.ops import norm as norm_ops
    from paddle_tpu_torch.ops import rope as rope_ops
    from paddle_tpu_torch.ops.kernels import (flash_attention, fused_norm,
                                              fused_rope)
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    H, HKV, HD = 32, 8, 128

    # -- RMSNorm backward: 2 x 4096 tokens at hidden 4096, fp32 weight -----
    R, D, eps = 8192, 4096, 1e-5
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        x = torch.randn((R, D), generator=g, device=dev).to(dt)
        dy = torch.randn((R, D), generator=g, device=dev).to(dt)
        w = 1 + 0.1 * torch.randn((D,), generator=g, device=dev)
        _, rstd = fused_norm.rms_norm_fwd(x, w, eps, return_rstd=True)
        dx, dw = fused_norm.rms_norm_bwd(x, w, rstd, dy)
        wdx, wdw = norm_ops._rms_norm_bwd_plain(x, w, rstd, dy)
        ex = compare(torch, dx, wdx, name)
        # dw sums 8192 rows in fp32 in another order: the rounding error
        # scales with the summands, not with the (often cancelling)
        # result, so dw is held to 1e-5 of its largest magnitude
        diff = (dw - wdw).abs()
        scale = float(wdw.abs().max())
        ew = (float(diff.max()), float(diff.max()) / scale,
              bool((diff <= 1e-5 * scale).all()))
        err = (max(ex[0], ew[0]), max(ex[1], ew[1]), ex[2] and ew[2])
        xr = x.detach().clone().requires_grad_()
        wr = w.to(dt).requires_grad_()
        yr = F.rms_norm(xr, (D,), wr, eps)
        e = x.element_size()
        record("rms_norm_bwd", "train_8192", name, err,
               timed_ms(torch, lambda: fused_norm.rms_norm_bwd(
                   x, w, rstd, dy), flush),
               timed_ms(torch, lambda: norm_ops._rms_norm_bwd_plain(
                   x, w, rstd, dy), flush),
               timed_ms(torch, lambda: torch.autograd.grad(
                   yr, (xr, wr), dy, retain_graph=True), flush),
               bound(3 * R * D * e + R * 4 + 2 * D * 4, 9 * R * D))
        del x, dy, dx, wdx, xr, yr

    # -- RoPE backward: the forward kernel with the negated sine table ------
    cos, sin = rope_ops.rope_freqs(HD, 8192, 500000.0, device=dev)
    gq = torch.randn((2, 4096, H, HD), generator=g, device=dev).to(
        torch.bfloat16)
    gk = torch.randn((2, 4096, HKV, HD), generator=g, device=dev).to(
        torch.bfloat16)
    got = fused_rope.fused_rope(gq, gk, cos, -sin)
    want = rope_ops._rope_plain(gq, gk, cos, -sin)
    ea, eb = (compare(torch, a, b, "bfloat16") for a, b in zip(got, want))
    record("fused_rope", "train_bwd_4096", "bfloat16",
           (max(ea[0], eb[0]), max(ea[1], eb[1]), ea[2] and eb[2]))
    del gq, gk, got, want

    # -- flash attention -----------------------------------------------------
    def flash_case(case, b, s, dt, seg=False, dropout_p=0.0, timed=False):
        name = str(dt).split(".")[-1]
        q = torch.randn((b, s, H, HD), generator=g, device=dev).to(dt)
        k = torch.randn((b, s, HKV, HD), generator=g, device=dev).to(dt)
        # v a strided view, as the split of the fused qkv projection
        vbuf = torch.randn((b, s, 2 * HKV, HD), generator=g,
                           device=dev).to(dt)
        v = vbuf[:, :, HKV:]
        dout = torch.randn((b, s, H, HD), generator=g, device=dev).to(dt)
        q_seg = kv_seg = None
        if seg:
            q_seg = (torch.arange(s, device=dev) // 300).to(torch.int32)
            q_seg = q_seg.expand(b, s).contiguous()
            kv_seg = q_seg.clone()
            q_seg[:, -40:] = 99                 # no key has id 99
        args = (True, HD ** -0.5, q_seg, kv_seg, dropout_p, 2024)
        out, lse = flash_attention.flash_fwd(q, k, v, *args)
        want_out, want_lse = attn_ops._flash_fwd_plain(q, k, v, *args)
        delta = (want_out.float() * dout.float()).sum(-1).transpose(
            1, 2).contiguous()
        dq, dk, dv = flash_attention.flash_bwd(q, k, v, dout, want_lse,
                                               delta, *args)
        wdq, wdk, wdv = attn_ops._flash_bwd_plain(q, k, v, dout, want_lse,
                                                  delta, *args)
        e = q.element_size()
        peak = BF16_OPS_PER_S if dt == torch.bfloat16 else FP32_OPS_PER_S
        pairs = b * H * s * (s + 1) // 2            # causal (q, k) pairs
        qb, kvb = b * s * H * HD * e, b * s * HKV * HD * e
        rowb = b * H * s * 4                         # lse or delta
        t = {}
        if timed:
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                          for x in (q, k, v))
            lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True,
                                                     enable_gqa=True)
            dot = dout.transpose(1, 2)
            plain_reps = 10 if s > 2048 else 25
            t["flash_fwd"] = (
                timed_ms(torch, lambda: flash_attention.flash_fwd(
                    q, k, v, *args), flush),
                timed_ms(torch, lambda: attn_ops._flash_fwd_plain(
                    q, k, v, *args), flush, reps=plain_reps),
                timed_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), flush))
            lib_bwd = timed_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), dot, retain_graph=True), flush)
            plain_bwd = timed_ms(torch, lambda: attn_ops._flash_bwd_plain(
                q, k, v, dout, want_lse, delta, *args), flush,
                reps=plain_reps)
            # the backward's every launch: the workspace's zeroing, the
            # kernel, the cast of dq
            t["flash_bwd"] = (
                timed_ms(torch, lambda: flash_attention.flash_bwd(
                    q, k, v, dout, want_lse, delta, *args), flush),
                plain_bwd, lib_bwd)
            del lib_out, qt, kt, vt
        # operations: the forward's 2 products, the backward's 5 (S, dP,
        # dV, dK, dQ), 2 * HD each per causal (q, k) pair
        ops = {"flash_fwd": 4 * HD * pairs, "flash_bwd": 10 * HD * pairs}
        bounds = {"flash_fwd": bound(qb + 2 * kvb + qb + rowb,
                                     ops["flash_fwd"], peak),
                  "flash_bwd": bound(3 * qb + 4 * kvb + 2 * rowb,
                                     ops["flash_bwd"], peak)}
        eo = flash_compare(torch, [(out, want_out)], name)
        el = compare(torch, lse, want_lse, "float32")
        errs = {"flash_fwd": (max(eo[0], el[0]), max(eo[1], el[1]),
                              eo[2] and el[2], eo[3]),
                "flash_bwd": flash_compare(
                    torch, [(dq, wdq), (dk, wdk), (dv, wdv)], name)}
        for kern in ("flash_fwd", "flash_bwd"):
            kms, pms, lms = t.get(kern, (None, None, None))
            record(kern, case, name, errs[kern], kms, pms, lms,
                   bounds[kern] if timed else (None, None))
            if kms is not None:
                rate = {"tflops": ops[kern] / kms / 1e9,
                        "library_tflops": ops[kern] / lms / 1e9,
                        "bound_share": bounds[kern][0] / kms}
                RESULTS.setdefault("flash_rates", {})[
                    f"{kern}/{case}/{name}"] = rate
                log(f"kernel {kern} [{case} {name}]: {us(kms)} = "
                    f"{rate['tflops']:.1f} TFLOP/s ({ops[kern]:.4g} "
                    f"operations), library {rate['library_tflops']:.1f} "
                    f"TFLOP/s, {rate['bound_share']:.3f} of the bound")
        if dt == torch.bfloat16:
            runs_agree(torch, flash_attention, case, (dq, dk, dv),
                       (q, k, v, dout, want_lse, delta, *args))
        if timed and dt == torch.bfloat16:
            planted_tile(torch, flash_attention, args, q, k, v, dout,
                         want_lse, delta,
                         {"flash_fwd": [want_out],
                          "flash_bwd/dq": [wdq],
                          "flash_bwd/dk_dv": [wdk, wdv]})
        torch.cuda.synchronize()

    def small_heads(case, d):
        """The training shape's bf16 backward at head dim ``d`` (64 and 32
        add dq in both warpgroups, ordered): two runs equal to the bit."""
        q = torch.randn((2, 4096, H, d), generator=g, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((2, 4096, HKV, d), generator=g, device=dev).to(
            torch.bfloat16) for _ in range(2))
        dout = torch.randn_like(q)
        args = (True, d ** -0.5, None, None, 0.0, 0)
        out, lse = flash_attention.flash_fwd(q, k, v, *args)
        delta = (out.float() * dout.float()).sum(-1).transpose(
            1, 2).contiguous()
        first = flash_attention.flash_bwd(q, k, v, dout, lse, delta, *args)
        runs_agree(torch, flash_attention, case, first,
                   (q, k, v, dout, lse, delta, *args))
        torch.cuda.synchronize()

    flash_case("train_4096", 2, 4096, torch.bfloat16, timed=True)
    torch.cuda.empty_cache()
    flash_case("s1024", 2, 1024, torch.float32, timed=True)
    flash_case("segments_1024", 2, 1024, torch.bfloat16, seg=True)
    flash_case("dropout_1024", 2, 1024, torch.bfloat16, dropout_p=0.1)
    flash_case("ragged_1000", 2, 1000, torch.bfloat16)
    small_heads("train_4096_d64", 64)
    small_heads("train_4096_d32", 32)
    del flush
    torch.cuda.empty_cache()


def ce_compare(torch, pairs, atol):
    """compare() of fp32 results held to ``atol`` alone: (max_abs,
    max_rel, ok) over the (got, want) pairs."""
    diffs = [((g.float() - w.float()).abs(), w.float()) for g, w in pairs]
    max_abs = max(float(d.max()) for d, _ in diffs)
    max_rel = max(float((d / w.abs().clamp_min(1e-6)).max())
                  for d, w in diffs)
    ok = max_abs <= atol and all(bool(torch.isfinite(g).all())
                                 for g, _ in pairs)
    return max_abs, max_rel, ok


def product_rate(kern, case, ops, bnd, kms, lms, key="ce_rates"):
    """Log and keep a timed bf16 product's rate under RESULTS[key]
    (``ce_rates``, or ``gemm_rates`` for the int8 prefill and grouped
    rows): TFLOP/s of the kernel and of the library call, and the share of
    the bound it reaches."""
    rate = {"tflops": ops / kms / 1e9,
            "library_tflops": ops / lms / 1e9 if lms else None,
            "bound_share": bnd[0] / kms}
    RESULTS.setdefault(key, {})[f"{kern}/{case}"] = rate
    lib = ("-" if lms is None else f"{rate['library_tflops']:.1f} TFLOP/s")
    log(f"kernel {kern} [{case} bfloat16]: {us(kms)} = "
        f"{rate['tflops']:.1f} TFLOP/s ({ops:.4g} operations), library "
        f"{lib}, {rate['bound_share']:.3f} of the bound")


def ce_bwd_rows(torch, kce, vocab_ce, case, h, w, labels, lse, g_lse, g_tgt,
                flush):
    """dlog, dh and dW of one vocabulary chunk (columns 0 .. CHUNK) at the
    shape of h [N, H] and W [H, V], bf16: each kernel launched once and
    held per row (dlog, dh) or per column (dW) against its plain version,
    timed beside the plain version and one torch.matmul of the same
    product (dlog: none), with its rate. dh adds to the fp32 sums of
    earlier chunks in the timed launches, as a middle chunk does."""
    N, H = h.shape
    C, e, bf = kce.CHUNK, 2, torch.bfloat16
    hf, lab = h.float(), labels.long()[:, None]
    dlog = torch.empty((N, C), dtype=bf, device=h.device)
    kce.vocab_ce_dlog(h, w, labels, lse, g_lse, g_tgt, 0, C, dlog)
    want_dlog, wc32 = vocab_ce._dlog_plain(hf, w, lab, lse, g_lse, g_tgt, 0,
                                           C)
    want_dlog = want_dlog.to(bf)
    ops = 2 * N * H * C
    bnd = bound(N * H * e + H * C * e + 4 * N * 4 + N * C * e, ops,
                BF16_OPS_PER_S)
    kms = timed_ms(torch, lambda: kce.vocab_ce_dlog(
        h, w, labels, lse, g_lse, g_tgt, 0, C, dlog), flush)
    record("vocab_ce_dlog", case, "bfloat16",
           flash_compare(torch, [(dlog, want_dlog)], "bfloat16"), kms,
           timed_ms(torch, lambda: vocab_ce._dlog_plain(
               hf, w, lab, lse, g_lse, g_tgt, 0, C)[0].to(bf), flush,
                    reps=10), None, bnd)
    product_rate("vocab_ce_dlog", case, ops, bnd, kms, None)
    del want_dlog

    wc = w[:, :C]
    out_dh = torch.empty_like(h)
    kce.vocab_ce_dh(dlog, w, 0, C, out_dh)
    want_dh = dlog.float() @ wc32.t()
    acc = torch.zeros((N, H), dtype=torch.float32, device=h.device)
    bnd = bound(N * C * e + H * C * e + 2 * N * H * 4, ops, BF16_OPS_PER_S)
    kms = timed_ms(torch, lambda: kce.vocab_ce_dh(
        dlog, w, 0, C, out_dh, acc, first=False, last=False), flush)
    lms = timed_ms(torch, lambda: torch.matmul(dlog, wc.t()), flush)
    record("vocab_ce_dh", case, "bfloat16",
           flash_compare(torch, [(out_dh, want_dh)], "bfloat16"), kms,
           timed_ms(torch, lambda: dlog.float() @ wc32.t(), flush, reps=10),
           lms, bnd)
    product_rate("vocab_ce_dh", case, ops, bnd, kms, lms)
    del out_dh, want_dh, acc

    out_dw = torch.empty_like(w)
    kce.vocab_ce_dw(h, dlog, 0, C, out_dw)
    want_dw = hf.t() @ dlog.float()
    bnd = bound(N * H * e + N * C * e + H * C * e, ops, BF16_OPS_PER_S)
    kms = timed_ms(torch, lambda: kce.vocab_ce_dw(h, dlog, 0, C, out_dw),
                   flush)
    lms = timed_ms(torch, lambda: torch.matmul(h.t(), dlog), flush)
    record("vocab_ce_dw", case, "bfloat16",
           flash_compare(torch, [(out_dw[:, :C].t(), want_dw.t())],
                         "bfloat16"), kms,
           timed_ms(torch, lambda: (hf.t() @ dlog.float()).to(bf), flush,
                    reps=10), lms, bnd)
    product_rate("vocab_ce_dw", case, ops, bnd, kms, lms)
    del out_dw, want_dw, wc32, dlog


def phase_ce_kernels(torch, pt):
    """Phase 3, the fused vocab-CE kernels. At the training shape (2 x
    4096 tokens, hidden 4096, vocabulary 128256, bf16): the forward, the
    dlog of one chunk, and dh and dW of the whole backward against the
    plain versions, timed per launch beside the plain version and the
    PyTorch yardstick, with the backward's TFLOP/s and share of the
    bound, and with planted wrong vocabulary blocks. dlog, dh and dW of
    one chunk again at the DeepSeekMoE-16B head (hidden 2048, vocabulary
    102400), and the whole backward's time at both shapes. In fp32
    at 2048 x 1024 over a vocabulary of 20000 (not a multiple of the
    tile, three backward chunks) with ignored rows and a tied,
    transposed W, through the autograd Function. Runs with autograd
    on."""
    from paddle_tpu_torch.ops import vocab_ce
    from paddle_tpu_torch.ops.kernels import fused_vocab_ce as kce
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(5678)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    N, H, V, C = 8192, 4096, 128256, kce.CHUNK
    bf, i32, e = torch.bfloat16, torch.int32, 2
    h = torch.randn((N, H), generator=g, device=dev).to(bf)
    w = (0.02 * torch.randn((H, V), generator=g, device=dev)).to(bf)
    labels = torch.randint(0, V, (N,), generator=g, device=dev).to(i32)
    labels[::97] = -1                                   # ignored rows
    # the blocks that the planted copies overwrite hold some rows' labels
    plants = {"mid": 500, "late": V // 128 - 2}
    for i, j in enumerate(plants.values()):
        labels[1 + 16 * i:9 + 16 * i] = (j + 1) * 128 + 13 * torch.arange(
            8, device=dev, dtype=i32)
    g_lse = torch.randn((N,), generator=g, device=dev)
    g_tgt = torch.randn((N,), generator=g, device=dev)
    hf, lab = h.float(), labels.long()[:, None]

    lse, tgt = kce.vocab_ce_fwd(h, w, labels)
    want_lse, want_tgt = vocab_ce._fwd_plain(h, w, labels)
    record("vocab_ce_fwd", "train_8192", "bfloat16",
           ce_compare(torch, [(lse, want_lse), (tgt, want_tgt)],
                      CE_FP32_TOL),
           timed_ms(torch, lambda: kce.vocab_ce_fwd(h, w, labels), flush,
                    reps=10),
           timed_ms(torch, lambda: vocab_ce._fwd_plain(h, w, labels), flush,
                    reps=10),
           timed_ms(torch, lambda: torch.logsumexp(
               torch.matmul(h, w).float(), -1), flush, reps=10),
           bound(N * H * e + H * V * e + 3 * N * 4, 2 * N * H * V,
                 BF16_OPS_PER_S), tol=CE_FP32_TOL)
    del lse, tgt

    dlog = torch.empty((N, C), dtype=bf, device=dev)
    kce.vocab_ce_dlog(h, w, labels, want_lse, g_lse, g_tgt, 0, C, dlog)
    want_dlog = vocab_ce._dlog_plain(hf, w, lab, want_lse, g_lse, g_tgt, 0,
                                     C)[0].to(bf)
    ops = 2 * N * H * C          # each of dlog, dh and dW, a chunk
    bnd = bound(N * H * e + H * C * e + 4 * N * 4 + N * C * e, ops,
                BF16_OPS_PER_S)
    kms = timed_ms(torch, lambda: kce.vocab_ce_dlog(
        h, w, labels, want_lse, g_lse, g_tgt, 0, C, dlog), flush)
    record("vocab_ce_dlog", "train_chunk_8192", "bfloat16",
           flash_compare(torch, [(dlog, want_dlog)], "bfloat16"), kms,
           timed_ms(torch, lambda: vocab_ce._dlog_plain(
               hf, w, lab, want_lse, g_lse, g_tgt, 0, C)[0].to(bf), flush,
                    reps=10),
           None, bnd)
    product_rate("vocab_ce_dlog", "train_chunk_8192", ops, bnd, kms, None)
    del want_dlog

    dh, dw = kce.vocab_ce_bwd(h, w, labels, want_lse, g_lse, g_tgt)
    want_dh, want_dw = vocab_ce._bwd_plain(h, w, labels, want_lse, g_lse,
                                           g_tgt, C)
    # per launch at a middle chunk: dh adds to the fp32 sums of the
    # earlier chunks; the yardsticks are the chunk's product in one
    # torch.matmul, the plain versions the plain backward's steps
    acc = torch.empty((N, H), dtype=torch.float32, device=dev)
    out_dh, out_dw = torch.empty_like(h), torch.empty_like(w)
    wc = w[:, :C]
    bnd = bound(N * C * e + H * C * e + 2 * N * H * 4, ops, BF16_OPS_PER_S)
    kms = timed_ms(torch, lambda: kce.vocab_ce_dh(
        dlog, w, 0, C, out_dh, acc, first=False, last=False), flush)
    lms = timed_ms(torch, lambda: torch.matmul(dlog, wc.t()), flush)
    record("vocab_ce_dh", "train_8192", "bfloat16",
           flash_compare(torch, [(dh, want_dh)], "bfloat16"), kms,
           timed_ms(torch, lambda: dlog.float() @ wc.float().t(), flush,
                    reps=10), lms, bnd)
    product_rate("vocab_ce_dh", "train_8192", ops, bnd, kms, lms)
    bnd = bound(N * H * e + N * C * e + H * C * e, ops, BF16_OPS_PER_S)
    kms = timed_ms(torch, lambda: kce.vocab_ce_dw(h, dlog, 0, C, out_dw),
                   flush)
    lms = timed_ms(torch, lambda: torch.matmul(h.t(), dlog), flush)
    record("vocab_ce_dw", "train_8192", "bfloat16",
           flash_compare(torch, [(dw.t(), want_dw.t())], "bfloat16"), kms,
           timed_ms(torch, lambda: (hf.t() @ dlog.float()).to(bf), flush,
                    reps=10), lms, bnd)
    product_rate("vocab_ce_dw", "train_8192", ops, bnd, kms, lms)
    del acc, out_dh, out_dw, dh, dw

    # the whole head: forward + backward of the kernels, of the plain
    # versions, and of the naive head through autograd (logits, fp32 CE)
    hr, wr = h.detach().requires_grad_(), w.detach().requires_grad_()
    naive = F.cross_entropy(torch.matmul(hr, wr).float(), labels.long(),
                            ignore_index=-1)
    head = {
        "kernels_bwd_ms": timed_ms(torch, lambda: kce.vocab_ce_bwd(
            h, w, labels, want_lse, g_lse, g_tgt), flush, reps=5),
        "plain_bwd_ms": timed_ms(torch, lambda: vocab_ce._bwd_plain(
            h, w, labels, want_lse, g_lse, g_tgt, C), flush, reps=3,
                                 warmup=1),
        "naive_autograd_bwd_ms": timed_ms(torch, lambda: torch.autograd.grad(
            naive, (hr, wr), retain_graph=True), flush, reps=10),
        "launches_per_bwd": -(-V // C) * 3,
        "bound_bwd_ms": bound(2 * N * H * e + 2 * H * V * e + 4 * N * 4,
                              6 * N * H * V, BF16_OPS_PER_S)[0]}
    RESULTS["vocab_ce_head"] = head
    log(f"vocab-CE backward at {N} x {H} x {V} bf16: {head}")
    del naive, hr, wr
    torch.cuda.empty_cache()
    planted_vocab_block(torch, kce, vocab_ce, h, w, labels, g_lse, g_tgt,
                        want_lse, want_tgt, want_dh, want_dw, plants)
    del h, w, dlog, want_dh, want_dw
    torch.cuda.empty_cache()

    # the backward at the DeepSeekMoE-16B head's shape (2 x 4096 tokens,
    # hidden 2048, vocabulary 102400: 12 full chunks and one of 4096)
    N3, H3, V3 = 8192, 2048, 102400
    h3 = torch.randn((N3, H3), generator=g, device=dev).to(bf)
    w3 = (0.02 * torch.randn((H3, V3), generator=g, device=dev)).to(bf)
    lab3 = torch.randint(0, V3, (N3,), generator=g, device=dev).to(i32)
    lab3[::97] = -1
    gl3 = torch.randn((N3,), generator=g, device=dev)
    gt3 = torch.randn((N3,), generator=g, device=dev)
    lse3, _ = vocab_ce._fwd_plain(h3, w3, lab3)
    ce_bwd_rows(torch, kce, vocab_ce, "moe_chunk_8192", h3, w3, lab3, lse3,
                gl3, gt3, flush)
    head3 = {
        "kernels_bwd_ms": timed_ms(torch, lambda: kce.vocab_ce_bwd(
            h3, w3, lab3, lse3, gl3, gt3), flush, reps=5),
        "launches_per_bwd": -(-V3 // C) * 3,
        "bound_bwd_ms": bound(2 * N3 * H3 * e + 2 * H3 * V3 * e + 4 * N3 * 4,
                              6 * N3 * H3 * V3, BF16_OPS_PER_S)[0]}
    RESULTS["vocab_ce_head_moe"] = head3
    log(f"vocab-CE backward at {N3} x {H3} x {V3} bf16: {head3}")
    del h3, w3, lab3, gl3, gt3, lse3
    torch.cuda.empty_cache()

    # fp32, tied: W is the transposed view of an embedding [V, H]
    N2, H2, V2 = 2048, 1024, 20000
    hx = torch.randn((N2, H2), generator=g, device=dev)
    emb = 0.05 * torch.randn((V2, H2), generator=g, device=dev)
    lab2 = torch.randint(0, V2, (N2,), generator=g, device=dev).to(i32)
    lab2[::5] = -1
    lab2[1] = V2 - 1                                # in the padded tile
    gl2 = torch.randn((N2,), generator=g, device=dev)
    gt2 = torch.randn((N2,), generator=g, device=dev)
    hr, er = hx.clone().requires_grad_(), emb.clone().requires_grad_()
    lse2, tgt2 = vocab_ce.lse_and_target(hr, er.t(), lab2)
    torch.autograd.backward((lse2, tgt2), (gl2, gt2))
    wl2, wt2 = vocab_ce._fwd_plain(hx, emb.t(), lab2)
    wdh2, wdw2 = vocab_ce._bwd_plain(hx, emb.t(), lab2, wl2, gl2, gt2)
    case = "tied_fp32_v20000"
    ef = [compare(torch, a, b, "float32") for a, b in
          ((lse2, wl2), (tgt2, wt2))]
    record("vocab_ce_fwd", case, "float32",
           (max(x[0] for x in ef), max(x[1] for x in ef),
            all(x[2] for x in ef)))
    record("vocab_ce_dh", case, "float32",
           compare(torch, hr.grad, wdh2, "float32"))
    record("vocab_ce_dw", case, "float32",
           compare(torch, er.grad, wdw2.t(), "float32"))
    if bool((tgt2[::5] != 0).any()):
        FAILED_CASES.append("vocab_ce_fwd/ignored_rows_tgt_not_0")
    del flush
    torch.cuda.empty_cache()


def planted_vocab_block(torch, kce, vocab_ce, h, w, labels, g_lse, g_tgt,
                        want_lse, want_tgt, want_dh, want_dw, plants):
    """Run the CE kernels as if they read vocabulary block j's W in place
    of block j + 1's (both 128 columns; block j + 1 holds 8 rows'
    labels) and hold them against the plain versions of the true W: the
    forward's lse/tgt reading must be at least 10x CE_FP32_TOL, and the
    row checks of the chunk's dlog, of dh and of dW must reject it. A
    failure means the check cannot see a wrong block."""
    N, V, C = h.shape[0], w.shape[1], kce.CHUNK
    hf, lab = h.float(), labels.long()[:, None]
    res = {}
    for where, j in plants.items():
        w2 = w.clone()
        w2[:, (j + 1) * 128:(j + 2) * 128] = w[:, j * 128:(j + 1) * 128]
        lse2, tgt2 = kce.vocab_ce_fwd(h, w2, labels)
        e_lse = ce_compare(torch, [(lse2, want_lse)], CE_FP32_TOL)
        e_tgt = ce_compare(torch, [(tgt2, want_tgt)], CE_FP32_TOL)
        reading = max(e_lse[0], e_tgt[0])
        c0 = (j + 1) * 128 // C * C
        cw = min(C, V - c0)
        dlog = torch.empty((N, C), dtype=h.dtype, device=h.device)
        kce.vocab_ce_dlog(h, w2, labels, want_lse, g_lse, g_tgt, c0, cw,
                          dlog)
        want_dlog = vocab_ce._dlog_plain(hf, w, lab, want_lse, g_lse, g_tgt,
                                         c0, cw)[0].to(h.dtype)
        dh2, dw2 = kce.vocab_ce_bwd(h, w2, labels, want_lse, g_lse, g_tgt)
        checks = {
            "vocab_ce_dlog": flash_compare(
                torch, [(dlog[:, :cw], want_dlog)], "bfloat16"),
            "vocab_ce_dh": flash_compare(torch, [(dh2, want_dh)],
                                         "bfloat16"),
            "vocab_ce_dw": flash_compare(torch, [(dw2.t(), want_dw.t())],
                                         "bfloat16")}
        caught = reading >= 10 * CE_FP32_TOL
        res[f"vocab_ce_fwd/{where}"] = {
            "lse_max_abs": e_lse[0], "tgt_max_abs": e_tgt[0],
            "caught_10x": caught}
        log(f"planted wrong vocabulary block ({where}, block {j} read as "
            f"{j + 1}) in vocab_ce_fwd: lse max_abs_err={e_lse[0]:.3e}, "
            f"tgt max_abs_err={e_tgt[0]:.3e} vs tol {CE_FP32_TOL} "
            f"({'rejected by 10x or more' if caught else 'NOT 10x above'})")
        if not caught:
            FAILED_CASES.append(f"vocab_ce_fwd/planted_block_{where}_missed")
        for kern, e in checks.items():
            res[f"{kern}/{where}"] = {"row_err": e[3], "row_caught": not e[5],
                                      "max_abs_err": e[0]}
            log(f"planted wrong vocabulary block ({where}) in {kern}: "
                f"row_err={e[3]:.3e} vs row_tol {ROW_TOL} (row check "
                f"{'rejects' if not e[5] else 'MISSES'} it)")
            if e[5]:
                FAILED_CASES.append(f"{kern}/planted_block_{where}_missed")
        del w2, dlog, dh2, dw2
    RESULTS["planted_vocab_block"] = res


def runs_agree(torch, fa, case, first, bwd_args):
    """D14: the bf16 flash backward run again on the same inputs gives
    dq, dk and dv equal to ``first`` bit for bit (the dQ adds go in a
    fixed order); a difference fails the case."""
    again = fa.flash_bwd(*bwd_args)
    equal = {n: bool(torch.equal(a, b))
             for n, a, b in zip(("dq", "dk", "dv"), first, again)}
    RESULTS.setdefault("flash_bwd_repeat", {})[case] = equal
    log(f"kernel flash_bwd [{case} bfloat16] a second run equal to the "
        f"first bit for bit: {equal}")
    if not all(equal.values()):
        FAILED_CASES.append(f"flash_bwd/{case}/runs_differ")


def planted_tile(torch, fa, args, q, k, v, dout, lse, delta, wants):
    """Run the flash kernels as if they read one tile in place of another
    (tile A's rows of one KV head, or of one query head with its dout,
    lse and delta, copied over tile B, once in the middle of the
    sequence and once at its end) and hold them against the plain
    versions of the true inputs: a K/V plant must break the forward's out
    and the backward's dq, a Q/dO/lse/delta plant the backward's dk and
    dv, and the row check must reject every one. A failure means the
    check cannot see a wrong tile."""
    s = q.shape[1]
    res = {}
    for where, b0 in (("mid", s // 2), ("late", s - 128)):
        A, B = slice(b0 - 64, b0), slice(b0, b0 + 64)

        def plant(t, seq_dim=1):
            t = t.clone()
            if seq_dim == 1:                   # [b, s, heads, d]
                t[:, B, 0] = t[:, A, 0]
            else:                              # lse / delta [b, h, s]
                t[:, 0, B] = t[:, 0, A]
            return t
        k2, v2 = plant(k), plant(v)
        kv_planted = fa.flash_bwd(q, k2, v2, dout, lse, delta, *args)
        q_planted = fa.flash_bwd(plant(q), k, v, plant(dout), plant(lse, 2),
                                 plant(delta, 2), *args)
        got = {"flash_fwd": [fa.flash_fwd(q, k2, v2, *args)[0]],
               "flash_bwd/dq": [kv_planted[0]],
               "flash_bwd/dk_dv": list(q_planted[1:])}
        for kern, outs in got.items():
            e = flash_compare(torch, list(zip(outs, wants[kern])),
                              "bfloat16")
            res[f"{kern}/{where}"] = {
                "row_err": e[3], "row_caught": not e[5],
                "elementwise_caught": not e[4], "max_abs_err": e[0]}
            log(f"planted wrong tile ({where}) in {kern}: max_abs_err="
                f"{e[0]:.3e} (elementwise check "
                f"{'rejects' if not e[4] else 'passes'} it), row_err="
                f"{e[3]:.3e} vs row_tol {ROW_TOL} (row check "
                f"{'rejects' if not e[5] else 'MISSES'} it)")
            if e[5]:
                FAILED_CASES.append(f"{kern}/planted_tile_{where}_missed")
    RESULTS["planted_tile"] = res


def plain_greedy(torch, model, prompt, n_new, page_size):
    """Step-by-step greedy decoding through the paged model functions on
    the model's device (the CPU: plain versions), one request at a
    time, independent of the engine's scheduling."""
    core = model.model
    L = len(prompt)
    pools, tables = core.alloc_paged_caches(1, L + n_new, page_size)
    h, _ = core.prefill_paged(torch.tensor(prompt[None], dtype=torch.int64),
                              pools, tables)
    logits = model.logits(h[0, L - 1])
    out = []
    for i in range(n_new):
        tok = int(torch.argmax(logits.float()))
        out.append(tok)
        if i == n_new - 1:
            break
        h, _ = core.decode_step_paged(torch.tensor([tok]),
                                      torch.tensor([L + i]), pools, tables)
        logits = model.logits(h[0, 0])
    return np.asarray(out, np.int32)


def phase_engine_equality(torch, pt, dev, make_cfg):
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.models import LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = make_cfg(num_hidden_layers=2, dtype="float32")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(7, dev))
    ref = copy.deepcopy(model).to("cpu")
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (37, 130, 64, 200)]
    n_new = 8
    eng = ContinuousBatchingEngine(
        model, max_batch=2, page_size=128, max_len=512,
        generation_config=GenerationConfig(max_new_tokens=n_new),
        decode_block=4, async_depth=2)
    rids = [eng.submit(p) for p in prompts]
    out = eng.run()
    with torch.inference_mode():
        want = [plain_greedy(torch, ref, p, n_new, 128) for p in prompts]
    same = [bool(np.array_equal(out[r], w)) for r, w in zip(rids, want)]
    log(f"engine equality (llama3_8b widths, 2 layers, fp32): "
        f"{sum(same)}/{len(same)} requests equal, "
        f"{time.perf_counter() - t0:.1f} s")
    RESULTS["engine_equality"] = {"equal": same,
                                  "card": [out[r].tolist() for r in rids],
                                  "plain": [w.tolist() for w in want]}
    del eng, model, ref
    empty_cache(torch, dev)
    if not all(same):
        raise SystemExit("engine tokens differ from the plain path: "
                         f"{RESULTS['engine_equality']}")


GEN_CASES = ((2, 120, 16), (1, 128, 8))   # rows, prompt tokens, new
GEN_PAGE = 128


def phase_generation_equality(torch, pt, dev, make_cfg):
    """Phase 4f: one-shot generation on the card against the plain path
    on the CPU (module docstring)."""
    from paddle_tpu_torch.inference import generation as gen
    from paddle_tpu_torch.models import LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = make_cfg(num_hidden_layers=2, dtype="float32")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(7, dev))
    ref = copy.deepcopy(model).to("cpu")
    rs = np.random.RandomState(7)
    generators = {"generate": {}, "generate_scan": {},
               "generate_paged": {"page_size": GEN_PAGE}}
    info, bad = {"cases": []}, []
    for b, L, n in GEN_CASES:
        ids = rs.randint(0, cfg.vocab_size, (b, L))
        ids_dev = torch.as_tensor(ids, device=dev)
        greedy = gen.GenerationConfig(max_new_tokens=n)
        got = {name: getattr(gen, name)(model, ids_dev, greedy,
                                        **kw)[:, L:].cpu().numpy()
               for name, kw in generators.items()}
        with torch.inference_mode():
            plain = np.stack([plain_greedy(torch, ref, ids[r], n, GEN_PAGE)
                              for r in range(b)])
        equal = {name: bool(np.array_equal(g, plain))
                 for name, g in got.items()}
        info["cases"].append({"rows": b, "prompt": L, "new": n,
                              "equal": equal, "plain": plain.tolist()})
        if not all(equal.values()):
            bad.append(f"greedy rows {b} x {L} + {n}: {equal}")
    # EOS and pad, and the sampled replay, on the first case's prompts
    b, L, n = GEN_CASES[0]
    ids = np.random.RandomState(7).randint(0, cfg.vocab_size, (b, L))
    ids_dev = torch.as_tensor(ids, device=dev)
    eos = gen.GenerationConfig(max_new_tokens=n, pad_token_id=-7,
                               eos_token_id=info["cases"][0]["plain"][0][0])
    card_eos = gen.generate_scan(model, ids_dev, eos).cpu().numpy()
    cpu_eos = gen.generate_scan(ref, torch.as_tensor(ids), eos).numpy()
    info["eos_equal"] = bool(np.array_equal(card_eos, cpu_eos)
                             and card_eos[0, -1] == -7)
    if not info["eos_equal"]:
        bad.append(f"EOS: card {card_eos[:, L:].tolist()} cpu "
                   f"{cpu_eos[:, L:].tolist()}")
    sampled = gen.GenerationConfig(max_new_tokens=n, do_sample=True,
                                   temperature=0.8, top_k=50, top_p=0.9,
                                   seed=3)
    s1 = gen.generate_scan(model, ids_dev, sampled)
    s2 = gen.generate_scan(model, ids_dev, sampled)
    s3 = gen.generate(model, ids_dev, sampled)
    info["sampled_replay"] = bool(torch.equal(s1, s2))
    info["sampled_equals_generate"] = bool(torch.equal(s1, s3))
    if not (info["sampled_replay"] and info["sampled_equals_generate"]):
        bad.append(f"sampled: replay {info['sampled_replay']}, equals "
                   f"generate {info['sampled_equals_generate']}")
    greedy = gen.GenerationConfig(max_new_tokens=n)
    gen.generate_paged(model, ids_dev, greedy, page_size=GEN_PAGE)
    info["sync_free"] = None          # off the card: nothing to sync
    if dev.type == "cuda":
        sync(torch, dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            gen.generate_scan(model, ids_dev, sampled)
            gen.generate_paged(model, ids_dev, greedy, page_size=GEN_PAGE)
            info["sync_free"] = True
        except RuntimeError as e:
            info["sync_free"] = False
            bad.append(f"a generator synced the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    log(f"generation equality (llama3_8b widths, 2 layers, fp32): "
        f"{[c['equal'] for c in info['cases']]}; EOS equal "
        f"{info['eos_equal']}; sampled replay {info['sampled_replay']}, "
        f"equals generate {info['sampled_equals_generate']}; sync-free "
        f"{info['sync_free']}; {time.perf_counter() - t0:.1f} s")
    RESULTS["generation_equality"] = info
    del model, ref
    empty_cache(torch, dev)
    if bad:
        raise SystemExit(f"generation differs: {bad}")


def phase_generation_mesh(torch, pt, dev, make_cfg):
    """4f on a mesh, run after phase 12 (module docstring): 4f's model
    again (seed 7, 2 layers, fp32) on 4f's first case. It runs beside
    the other world-size-1 NCCL legs, so that no communicator comes up
    before the single-card phases 5-11. Returns the sharded calls'
    launches."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    cfg = make_cfg(num_hidden_layers=2, dtype="float32")
    model = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(7, dev))
    b, L, n = GEN_CASES[0]
    ids = np.random.RandomState(7).randint(0, cfg.vocab_size, (b, L))
    out = generation_mesh(torch, dev, model,
                          torch.as_tensor(ids, device=dev), n)
    RESULTS.setdefault("generation_equality", {})["mesh"] = out
    del model
    empty_cache(torch, dev)
    if not out["ok"]:
        raise SystemExit(f"generation on a mesh differs: {out['equal']}, "
                         f"launches {out['launches']}")
    return out["launches"]


def generation_mesh(torch, dev, model, ids, n):
    """4f on a mesh: the process group at world size 1 (NCCL on the
    card, as phase 12(a); gloo on the CPU), ``shard_layer`` of a copy of
    ``model``, then ``generate_scan`` and ``generate_paged``: the greedy
    tokens must equal the unsharded model's bit for bit, and the sharded
    calls' RMSNorm, RoPE and paged decode launches (counts reset just
    before, read just after) must be non-zero on the card."""
    import torch.distributed as dist
    from paddle_tpu_torch.inference import generation as gen
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.parallel.api import shard_layer
    from paddle_tpu_torch.parallel.mesh import init_parallel_env
    greedy = gen.GenerationConfig(max_new_tokens=n)
    calls = {"generate_scan": {}, "generate_paged": {"page_size": GEN_PAGE}}
    t0 = time.perf_counter()
    want = {c: getattr(gen, c)(model, ids, greedy, **kw)
            for c, kw in calls.items()}
    sharded = copy.deepcopy(model)
    cuda = dev.type == "cuda"
    hm = init_parallel_env(backend="nccl" if cuda else "gloo",
                           init_method=f"tcp://localhost:{free_port()}",
                           world_size=1, rank=0, device=dev.type)
    try:
        with hm:
            shard_layer(sharded, hm)
            _build.reset_launches()
            got = {c: getattr(gen, c)(sharded, ids, greedy, **kw)
                   for c, kw in calls.items()}
            sync(torch, dev)
            launches = dict(_build.LAUNCHES)
    finally:
        dist.destroy_process_group()
    equal = {c: bool(torch.equal(got[c], want[c])) for c in calls}
    counted = {k: launches.get(k, 0) for k in SERVING_KERNELS}
    out = {"mesh_shape": hm.shape, "equal": equal, "launches": launches,
           "seconds": time.perf_counter() - t0,
           "ok": all(equal.values()) and (
               not cuda or all(v > 0 for v in counted.values()))}
    log(f"generation on a mesh (4f): world size 1 "
        f"({'NCCL' if cuda else 'gloo'}), mesh {hm.shape}, shard_layer, "
        f"{ids.shape[0]} x {ids.shape[1]} + {n}: tokens equal to the "
        f"unsharded model's {equal}; launches of the sharded calls "
        f"{counted}; {out['seconds']:.1f} s {card_line()}")
    del sharded, want, got
    return out


def fabric_prompts(V):
    """Phase 4's four prompts (numpy seed 7) and two longer ones (seed 9)."""
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, V, (n,)).astype(np.int32)
               for n in (37, 130, 64, 200)]
    rs = np.random.RandomState(9)
    return prompts + [rs.randint(0, V, (n,)).astype(np.int32)
                      for n in (300, 450)]


def recording_transport(replicas):
    """An InProcTransport that keeps every adopted payload with its
    destination (phase 4d holds them to the destination's pages)."""
    from paddle_tpu_torch.serving_fabric import InProcTransport

    # the replicas go in through the constructor: a class made here
    # lives in a reference cycle of its own, and a closure over them
    # would hold their engines on the card until a full collection
    class Recording(InProcTransport):
        def __init__(self, replicas):
            super().__init__(replicas)
            self.adopted = []

        def adopt(self, name, payload):
            n = super().adopt(name, payload)
            self.adopted.append((name, payload))
            return n
    return Recording(replicas)


def adopted_equal(torch, tr):
    """Each adopted payload against its destination's export of the same
    tokens: kv (and scales) equal bit for bit, the same sha256."""
    out = []
    for name, pay in tr.adopted:
        back = tr._replicas[name].engine.serialize_pages(pay["tokens"])
        same = (back is not None and back["sha256"] == pay["sha256"]
                and torch.equal(back["kv"], pay["kv"]))
        if pay.get("scales") is not None:
            same = same and torch.equal(back["scales"], pay["scales"])
        out.append(bool(same))
    return out


def phase_fabric_equality(torch, pt, dev, make_cfg, threshold=128):
    """Phase 4d: the serving fabric at Llama-3-8B widths, 2 layers, fp32,
    seeded weights: a prefill replica and a "both" replica over one
    model, disaggregation at ``threshold`` tokens. Every prompt at or
    over it is handed off; greedy tokens equal the plain path on the
    CPU; pages exported == adopted > 0 and the adopted pages equal the
    exporter's bit for bit; a forced-dense engine equals the paged one.
    Then the int8 arm: the same fabric over the quantized model, one
    request at a time, against one int8 engine with the prefix cache
    that serves a handed-off prompt as the fabric does (a one-token
    prefill first, then the request over its own cached pages); codes
    and scales adopted bit for bit, and a v1 payload refused."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_model
    from paddle_tpu_torch.serving_fabric import (ServingFabric,
                                                 build_replicas)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = make_cfg(num_hidden_layers=2, dtype="float32")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(7, dev))
    ref = copy.deepcopy(model).to("cpu")
    prompts = fabric_prompts(cfg.vocab_size)
    n_new, page, max_len = 8, 128, 512
    gc = GenerationConfig(max_new_tokens=n_new)
    long_ = [len(p) >= threshold for p in prompts]

    def fabric(m, **kw):
        tr = recording_transport(build_replicas(
            m, 2, roles=["prefill", "both"], page_size=page,
            max_len=max_len, generation_config=gc, **kw))
        fab = ServingFabric(tr, disagg_threshold_tokens=threshold)
        fids = [fab.submit(p, n_new) for p in prompts]
        out = fab.run()
        engines = [r.engine for r in tr._replicas.values()]
        st = fab.stats()
        counts = {"handoffs": fab.handoffs,
                  "handoff_failures": fab.handoff_failures,
                  "replicas_dead": st["replicas_dead"],
                  "readmitted": st["readmitted"],
                  "handed_off": sorted(len(p["tokens"]) for _, p in
                                       tr.adopted),
                  "pages_exported": sum(e.pages_exported for e in engines),
                  "pages_adopted": sum(e.pages_adopted for e in engines)}
        counts["adopted_equal"] = adopted_equal(torch, tr)
        return [out[f] for f in fids], counts, tr

    got, counts, _ = fabric(model)
    # phase 4 served its four prompts with the same seeded model: its
    # plain streams are theirs; the two longer prompts run here
    want = [np.asarray(w, np.int32)
            for w in RESULTS["engine_equality"]["plain"]]
    with torch.inference_mode():
        want += [plain_greedy(torch, ref, p, n_new, page)
                 for p in prompts[len(want):]]
    same = [bool(np.array_equal(g, w)) for g, w in zip(got, want)]

    def engine_tokens(crossover):
        eng = ContinuousBatchingEngine(model, page_size=page,
                                       max_len=max_len, generation_config=gc,
                                       attn_crossover=crossover)
        rids = [eng.submit(p) for p in prompts]
        out = eng.run()
        return [out[r] for r in rids], dict(eng.attn_path_ticks)
    dense, dense_ticks = engine_tokens(max_len)
    paged, paged_ticks = engine_tokens(0)
    dense_same = [bool(np.array_equal(a, b)) for a, b in zip(dense, paged)]
    handed_want = sorted((len(p) // page) * page
                         for p, lg in zip(prompts, long_) if lg)
    res = {"equal_plain": same, "counts": counts,
           "dense_equal_paged": dense_same, "dense_ticks": dense_ticks,
           "paged_ticks": paged_ticks, "streams": [g.tolist() for g in got]}
    log(f"fabric equality (llama3_8b widths, 2 layers, fp32; prefill + both "
        f"replicas, disagg at {threshold} tokens): {sum(same)}/{len(same)} "
        f"requests equal the plain path; {counts}; forced-dense engine "
        f"{sum(dense_same)}/{len(dense_same)} equal the paged one (ticks "
        f"{dense_ticks} / {paged_ticks})")
    ok = (all(same) and all(dense_same)
          and counts["handed_off"] == handed_want
          and counts["handoffs"] == sum(long_)
          and counts["handoff_failures"] == counts["readmitted"] == 0
          and not counts["replicas_dead"]
          and counts["pages_exported"] == counts["pages_adopted"] > 0
          and all(counts["adopted_equal"])
          and dense_ticks["paged"] == 0 < dense_ticks["dense"]
          and paged_ticks["dense"] == 0 < paged_ticks["paged"])
    # the int8 arm
    qmodel = quantize_model(model, kv_dtype="int8")
    del model
    qgot, qcounts, qtr = fabric(qmodel, max_batch=1, num_pages=32)
    single = ContinuousBatchingEngine(qmodel, max_batch=1, page_size=page,
                                      max_len=max_len, num_pages=32,
                                      generation_config=gc,
                                      prefix_cache=True)
    qwant = []
    for p, lg in zip(prompts, long_):
        if lg:
            single.submit(p, max_new_tokens=1)
            single.run()
        rid = single.submit(p)
        qwant.append(single.run()[rid])
    qsame = [bool(np.array_equal(g, w)) for g, w in zip(qgot, qwant)]
    name, pay = qtr.adopted[0]
    eng = qtr._replicas[name].engine
    v1 = dict(pay, fmt="pt-kv-pages-v1")
    free0 = sorted(eng._free)
    try:
        eng.adopt_pages(v1)
        v1_refused = False
    except ValueError:
        v1_refused = sorted(eng._free) == free0
    res["int8"] = {"equal_single": qsame, "counts": qcounts,
                   "v1_refused": v1_refused,
                   "streams": [w.tolist() for w in qwant]}
    log(f"fabric equality, int8 arm (one request at a time): "
        f"{sum(qsame)}/{len(qsame)} requests equal the single int8 engine; "
        f"{qcounts}; v1 payload refused {v1_refused}; "
        f"{time.perf_counter() - t0:.1f} s")
    RESULTS["fabric_equality"] = res
    ok = ok and (all(qsame) and v1_refused
                 and qcounts["handed_off"] == handed_want
                 and qcounts["handoff_failures"] == qcounts["readmitted"] == 0
                 and not qcounts["replicas_dead"]
                 and qcounts["pages_exported"] == qcounts["pages_adopted"] > 0
                 and all(qcounts["adopted_equal"]))
    del qmodel, ref, single, eng, qtr
    empty_cache(torch, dev)
    if not ok:
        raise SystemExit(f"fabric equality failed: {res}")


# -- the front door's clients (phases 4e and 5e) -----------------------------
#
# The clients run in a process of their own (``python3 chip_smoke.py
# --client-process``) that imports ``serving_fabric.client`` and nothing
# that imports torch, so the server's GIL carries the server alone. The
# parent writes one JSON command a line to its stdin and reads one JSON
# answer a line from its stdout (``Clients``). Every socket has a time
# limit; so has every answer.

CLIENT_IO_S = 300.0          # a client's socket timeout
# the hang legs' op budget: 3x the longest healthy op of the window
# before, and never below this (a healthy poll that admits several
# prompts at once may take a few times the longest single prefill)
MIN_OP_BUDGET_S = 1.0
# a half-open probe's budget in the hang legs: each probe of the hung
# replica (one a second, the breaker's cooldown) stalls the router this
# long, so it is kept short; a released replica that still finishes
# stale work fails a probe or two and is readmitted at the next
PROBE_BUDGET_S = 0.25
CLIENT_CALL_S = 600.0        # the longest the parent waits for one answer


def _client_streams(FabricClient, host, port, reqs, attempts):
    """One thread and one FabricClient a request, all started together.
    Each token is stamped when its ``tok`` event reaches the client:
    returns, a request, its tokens, the submit time, [(stamp, tokens)]
    per event, the finish time and the failure (typed where the door
    typed it)."""
    import threading

    class Stamping(FabricClient):
        def _recv(self, f):
            ev = super()._recv(f)
            self.last_ev_t = time.perf_counter()
            return ev

    out = [None] * len(reqs)

    def go(i, r):
        c = Stamping(host, port, max_attempts=attempts,
                     io_timeout_s=CLIENT_IO_S)
        stamps = []
        rec = {"id": r["id"], "t_submit": time.perf_counter()}
        try:
            res = c.generate(r["prompt"], r["max_new"],
                             knobs=r.get("knobs"),
                             deadline_ms=r.get("deadline_ms"),
                             request_id=r["id"],
                             on_token=lambda t: stamps.append(c.last_ev_t))
            rec.update(tokens=res.tokens, attempts=res.attempts,
                       retries=res.retries)
        except Exception as e:      # noqa: BLE001 — reported to the parent
            wire = getattr(e, "to_wire", None)
            rec.update(error=f"{type(e).__name__}: {e}",
                       wire=wire() if wire else None)
        rec["t_done"] = time.perf_counter()
        events = []
        for t in stamps:
            if events and events[-1][0] == t:
                events[-1][1] += 1
            else:
                events.append([t, 1])
        rec["events"] = events
        out[i] = rec

    ts = [threading.Thread(target=go, args=(i, r), daemon=True)
          for i, r in enumerate(reqs)]
    for t in ts:
        t.start()
    return ts, out


def _raw(host, port, timeout=CLIENT_IO_S):
    import socket
    s = socket.create_connection((host, port), timeout=10.0)
    s.settimeout(timeout)
    return s, s.makefile("rb")


def _raw_send(sock, msg):
    sock.sendall(json.dumps(msg).encode() + b"\n")


def _raw_recv(f):
    line = f.readline(1 << 20)
    if not line:
        raise ConnectionError("server closed the connection")
    return json.loads(line)


def client_process() -> int:
    """The client side of phases 4e and 5e (see above). Commands:
    ``streams`` (concurrent FabricClients; ``wait=False`` returns at once
    and ``join`` collects), ``sequential`` (one client, one request after
    another), ``frames`` (torn frames and a ping on one raw connection),
    ``partial`` (submit on a raw connection, read the first tokens, drop
    the connection), ``resume`` (resubmit with ``have``: the missing
    suffix), ``loris_open`` / ``loris_close`` (a client that never
    reads), ``flood`` (submits on one raw connection until a refusal)
    and ``exit``."""
    import socket
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.serving_fabric.client import FabricClient
    state = {}
    for line in sys.stdin:
        cmd = json.loads(line)
        op, host, port = cmd.get("op"), cmd.get("host"), cmd.get("port")
        ans: dict = {"op": op}
        try:
            if op == "exit":
                break
            if op in ("streams", "sequential"):
                if op == "sequential":
                    ans["results"] = []
                    for r in cmd["reqs"]:
                        ts, out = _client_streams(FabricClient, host, port,
                                                  [r], cmd.get("attempts", 3))
                        ts[0].join(CLIENT_IO_S)
                        ans["results"].append(out[0])
                else:
                    state["batch"] = _client_streams(
                        FabricClient, host, port, cmd["reqs"],
                        cmd.get("attempts", 3))
                    if cmd.get("wait", True):
                        op = "join"
                    else:
                        ans["started"] = len(cmd["reqs"])
            if op == "join":
                ts, out = state.pop("batch")
                for t in ts:
                    t.join(CLIENT_IO_S)
                ans["results"] = out
                ans["alive"] = sum(t.is_alive() for t in ts)
            elif op == "frames":
                s, f = _raw(host, port)
                s.sendall(b'{"op": "submit", "truncated\n')
                s.sendall(b'[1, 2, 3]\n')
                _raw_send(s, {"op": "frobnicate"})
                _raw_send(s, {"op": "submit"})
                _raw_send(s, {"op": "ping"})
                ans["events"] = [_raw_recv(f) for _ in range(5)]
                s.close()
            elif op in ("partial", "resume"):
                s, f = _raw(host, port)
                msg = {"op": "submit", "id": cmd["id"],
                       "prompt": cmd["prompt"],
                       "max_new_tokens": cmd["max_new"]}
                if op == "resume":
                    msg["have"] = cmd["have"]
                _raw_send(s, msg)
                toks, n = [], None
                while n is None:
                    ev = _raw_recv(f)
                    if ev.get("id") != cmd["id"]:
                        continue
                    if ev.get("ev") == "tok":
                        toks.extend(int(t) for t in ev["toks"])
                        if op == "partial":
                            break
                    elif ev.get("ev") == "done":
                        toks.extend(int(t) for t in ev.get("toks", ()))
                        n = int(ev["n"])
                    elif ev.get("ev") in ("reject", "cancelled"):
                        ans["event"] = ev
                        break
                if op == "partial":
                    # a real disconnect: the file object holds a second
                    # descriptor, so shut the socket down
                    s.shutdown(socket.SHUT_RDWR)
                f.close()
                s.close()
                ans.update(tokens=toks, n=n)
            elif op == "loris_open":
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                # a tiny receive window before connect and a long id, so
                # a few events fill both sides' buffers
                s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 2048)
                s.settimeout(10.0)
                s.connect((host, port))
                _raw_send(s, {"op": "submit", "id": cmd["id"],
                              "prompt": cmd["prompt"],
                              "max_new_tokens": cmd["max_new"]})
                state["loris"] = s
            elif op == "loris_close":
                state.pop("loris").close()
            elif op == "flood":
                s, f = _raw(host, port)
                for i in range(cmd["n"]):
                    _raw_send(s, {"op": "submit", "id": f"{cmd['id']}-{i}",
                                  "prompt": cmd["prompt"],
                                  "max_new_tokens": cmd["max_new"]})
                deadline = time.monotonic() + CLIENT_IO_S
                while "event" not in ans and time.monotonic() < deadline:
                    ev = _raw_recv(f)
                    if ev.get("ev") == "reject":
                        ans["event"] = ev
                s.close()
        except Exception as e:      # noqa: BLE001 — reported to the parent
            ans["error"] = f"{type(e).__name__}: {e}"
        print(json.dumps(ans), flush=True)
    if "loris" in state:
        state["loris"].close()
    return 0


class Clients:
    """The parent's end of ``client_process``: started on entry, told to
    exit (and killed if it does not) on exit."""

    def __init__(self, door):
        self.host, self.port = door.host, door.port

    def __enter__(self):
        import queue
        import subprocess
        import threading
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--client-process"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=env)
        self.lines: "queue.Queue" = queue.Queue()
        threading.Thread(target=lambda: [self.lines.put(ln) for ln in
                                         self.proc.stdout],
                         daemon=True).start()
        return self

    def retarget(self, door):
        self.host, self.port = door.host, door.port
        return self

    def call(self, op, timeout=CLIENT_CALL_S, **kw):
        import queue
        kw.update(op=op, host=self.host, port=self.port)
        self.proc.stdin.write(json.dumps(kw) + "\n")
        self.proc.stdin.flush()
        try:
            ans = json.loads(self.lines.get(timeout=timeout))
        except queue.Empty:
            raise SystemExit(f"client process: no answer to {op!r} in "
                             f"{timeout} s")
        if "error" in ans:
            raise SystemExit(f"client process: {op!r} failed: "
                             f"{ans['error']}")
        return ans

    def __exit__(self, *exc):
        try:
            self.proc.stdin.write(json.dumps({"op": "exit"}) + "\n")
            self.proc.stdin.close()
            self.proc.wait(timeout=30)
        except Exception:           # noqa: BLE001 — then it is killed
            self.proc.kill()
            self.proc.wait()
        return False


def client_latency(results):
    """Client-side numbers of one window: tokens/s (tokens ÷ first
    submit to last finish), TTFT (submit to the first token's event) and
    ITL (an event's gap since the previous one, divided among its
    tokens, as the engine and the router divide a drain), p50 / p99."""
    ok = [r for r in results if r.get("tokens") is not None]
    ttft = [r["events"][0][0] - r["t_submit"] for r in ok if r["events"]]
    itl = []
    for r in ok:
        ev = r["events"]
        for (t0, _), (t1, n) in zip(ev, ev[1:]):
            itl.extend([(t1 - t0) / n] * n)
    n_tok = sum(len(r["tokens"]) for r in ok)
    wall = (max(r["t_done"] for r in results)
            - min(r["t_submit"] for r in results))
    pct = lambda a, q: float(np.percentile(a, q)) if a else float("nan")
    return {"tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
            "ttft_p50_s": pct(ttft, 50), "ttft_p99_s": pct(ttft, 99),
            "itl_p50_s": pct(itl, 50), "itl_p99_s": pct(itl, 99)}


def timed_transport(replicas):
    """An InProcTransport that times every op that answered (a hung op
    raises and is not timed), keeps each adopted token run with its
    destination, and can hang a replica right after a given adopt
    (``hang_after = (replica, n)``: after the n-th adopt in all)."""
    from paddle_tpu_torch.serving_fabric import InProcTransport

    # the replicas go in through the constructor (see
    # recording_transport)
    class Timed(InProcTransport):
        def __init__(self, replicas):
            super().__init__(replicas)
            self.op_s: dict = {}
            self.adopts: list = []
            self.hang_after = None
            self.hung_at = None

        def _timed(self, op, name, fn, *a):
            t0 = time.perf_counter()
            out = fn(self, name, *a)
            self.op_s.setdefault(op, []).append(
                (name, time.perf_counter() - t0))
            return out

        def submit(self, name, req):
            return self._timed("submit", name, InProcTransport.submit, req)

        def poll(self, name):
            return self._timed("poll", name, InProcTransport.poll)

        def extract(self, name, tokens):
            return self._timed("extract", name, InProcTransport.extract,
                               tokens)

        def adopt(self, name, payload):
            n = self._timed("adopt", name, InProcTransport.adopt, payload)
            self.adopts.append((name, np.asarray(payload["tokens"])))
            if self.hang_after is not None \
                    and len(self.adopts) == self.hang_after[1]:
                self.hang(self.hang_after[0])
                self.hang_after = None
                self.hung_at = time.monotonic()
            return n

        def longest(self, ops=("poll", "submit", "extract", "adopt")):
            return max((s for op in ops for _, s in self.op_s.get(op, ())),
                       default=0.0)
    return Timed(replicas)


def frontdoor_stack(model, names, roles, threshold, policy, door_kw=None,
                    **engine_kw):
    """FrontDoor(ServingFabric(BreakerTransport(timed InProcTransport(
    build_replicas(...))))) started; returns (door, fabric, breaker,
    timed transport)."""
    from paddle_tpu_torch.serving_fabric import (BreakerTransport,
                                                 FrontDoor, ServingFabric,
                                                 build_replicas)

    class Stamped(BreakerTransport):
        """Keeps the monotonic time of each trip."""
        trip_t: list = []

        def _trip(self, name, why):
            super()._trip(name, why)
            self.trip_t.append(time.monotonic())
    tr = timed_transport(build_replicas(model, len(roles), roles=roles,
                                        names=names, **engine_kw))
    br = Stamped(tr)
    br.trip_t = []
    fab = ServingFabric(br, policy=policy,
                        disagg_threshold_tokens=threshold)
    return FrontDoor(fab, **(door_kw or {})).start(), fab, br, tr


def wait_for(cond, timeout_s, what):
    """Poll ``cond`` every 20 ms up to ``timeout_s``; fail the phase
    with ``what`` if it never holds."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise SystemExit(f"timed out after {timeout_s} s: {what}")
        time.sleep(0.02)
    return True


def serial_streams(model, prompts, n_new, rseeds=None, knobs=None,
                   **engine_kw):
    """One engine serving ``prompts`` (under ``rseeds``, with the
    sampled ``knobs`` where given): the streams a fabric must reproduce
    whatever its placement and batching."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    eng = ContinuousBatchingEngine(model, **engine_kw)
    rids = []
    for i, p in enumerate(prompts):
        k = knobs[i] if knobs else None
        gc = (GenerationConfig(max_new_tokens=n_new,
                               seed=eng.cfg.seed, **k) if k else None)
        rids.append(eng.submit(p, n_new, generation_config=gc,
                               rseed=None if rseeds is None else rseeds[i]))
    out = eng.run()
    return [out[r].tolist() for r in rids]


def hang_check(fab, br, tr, victim, budget_s, clients, reqs, after=1):
    """Hang ``victim`` right after the ``after``-th adopt from now, under
    op budgets of
    ``budget_s``, while ``reqs`` stream; then release it and wait for
    the half-open probe to readmit it. Returns the window's results, the
    seconds from the hang to the trip, and the token runs handed off
    before the hang."""
    from paddle_tpu_torch.serving_fabric.breaker import DEFAULT_OP_TIMEOUTS
    from paddle_tpu_torch.testing.chaos import unhang_replica
    for op in ("poll", "submit", "extract", "adopt"):
        br.op_timeouts[op] = budget_s
    br.probe_timeout_s = PROBE_BUDGET_S
    trips0, n0 = len(br.trip_t), len(tr.adopts)
    tr.hang_after, tr.hung_at = (victim, n0 + after), None
    # the streams end on the survivor whatever happens to the victim
    results = clients.call("streams", reqs=reqs)["results"]
    if tr.hung_at is None:
        raise SystemExit(f"hang leg: fewer than {after} handoffs, so "
                         f"{victim} was never hung")
    if len(br.trip_t) == trips0:
        raise SystemExit(f"hang leg: the breaker never tripped on hung "
                         f"{victim}")
    tripped_s = br.trip_t[trips0] - tr.hung_at
    handed = [toks for _, toks in tr.adopts[n0:]]
    unhang_replica(br, victim)
    wait_for(lambda: victim not in fab._dead and br.state(victim) ==
             "closed", 60.0, f"{victim} was never readmitted")
    br.op_timeouts.update(DEFAULT_OP_TIMEOUTS)
    return results, tripped_s, handed


def phase_frontdoor_equality(torch, pt, dev, make_cfg, threshold=128):
    """Phase 4e: the front door over phase 4d's fabric (2 layers, fp32,
    the same seeded model and prompts; untimed): FrontDoor(ServingFabric(
    BreakerTransport(InProcTransport(prefill + "both" replicas)),
    disagg_threshold_tokens=threshold)), driven by FabricClients in the
    client process. Greedy streams equal phase 4d's, sampled ones a
    serial engine's under the rseeds the door recorded; a torn frame gets
    an ``error`` event on a connection that lives and ``seq`` is gapless;
    a disconnect then a retry loses and repeats no token; a client that
    never reads is cancelled, its slot and pages returned, the other
    streams unharmed; a replica hung right after a handoff trips its
    breaker within a budget taken from the longest healthy op, the
    streams finish on the survivor exactly, and the half-open probe
    readmits it once released; a deadline miss and an overload are
    refused typed with ``retry_after_ms``. The int8 arm: the quantized
    model behind one replica pair (one slot each, 32 pages), three
    prompts one after another, equal to phase 4d's single int8 engine."""
    from paddle_tpu_torch.inference import GenerationConfig
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_model
    from paddle_tpu_torch.serving_fabric import (FrontDoor, InProcTransport,
                                                 LoadShedder, ServingFabric,
                                                 build_replicas)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = make_cfg(num_hidden_layers=2, dtype="float32")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(7, dev))
    prompts = [p.tolist() for p in fabric_prompts(cfg.vocab_size)]
    want = RESULTS["fabric_equality"]["streams"]
    n_new, page, max_len = 8, 128, 512
    kw = dict(page_size=page, max_len=max_len,
              generation_config=GenerationConfig(max_new_tokens=n_new))
    names, roles = ["r0", "r1"], ["prefill", "both"]
    res: dict = {}
    checks: dict = {}

    def stack(m=model, door_kw=None, **more):
        return frontdoor_stack(m, names, roles, threshold, "affinity",
                               door_kw, **dict(kw, **more))
    door, fab, br, tr = stack(door_kw=dict(outbox_max=64, write_stall_s=0.25,
                                           sndbuf=2048))
    try:
        with Clients(door) as cl:
            # streams: the six greedy prompts and four sampled copies
            reqs = [{"id": f"g{i}", "prompt": p, "max_new": n_new}
                    for i, p in enumerate(prompts)]
            reqs += [{"id": f"s{i}", "prompt": prompts[i], "max_new": n_new,
                      "knobs": SAMPLED_KNOBS} for i in range(4)]
            out = {r["id"]: r for r in cl.call("streams", reqs=reqs)[
                "results"]}
            checks["greedy_equal_4d"] = [out[f"g{i}"].get("tokens") == w
                                         for i, w in enumerate(want)]
            with door._flock:
                rseeds = [door._streams[f"s{i}"].rseed for i in range(4)]
            sampled_want = serial_streams(
                model, prompts[:4], n_new, rseeds,
                [SAMPLED_KNOBS] * 4, **kw)
            checks["sampled_equal_serial"] = [
                out[f"s{i}"].get("tokens") == w
                for i, w in enumerate(sampled_want)]
            longest = tr.longest()
            # framing
            evs = cl.call("frames")["events"]
            checks["torn_frames"] = (
                [e["ev"] for e in evs] == ["error"] * 4 + ["pong"]
                and [e["seq"] for e in evs] == list(range(5)))
            # a disconnect mid-stream, then a retry with ``have``
            n_long, p = 40, prompts[0]
            got = cl.call("partial", id="rt", prompt=p, max_new=n_long)
            wait_for(lambda: door.stream_states().get("rt") == "orphaned",
                     60.0, "the dropped stream never orphaned")
            rest = cl.call("resume", id="rt", prompt=p, max_new=n_long,
                           have=len(got["tokens"]))
            resumed = got["tokens"] + rest["tokens"]
            ref = serial_streams(model, [p], n_long, **kw)[0]
            checks["resume_exact"] = (0 < len(got["tokens"]) < n_long
                                      and rest["n"] == n_long
                                      and resumed == ref
                                      and door.retries >= 1)
            # a client that never reads, beside eight that do
            loris = "slow-" + "x" * 8000
            cl.call("loris_open", id=loris, prompt=[1] * 6, max_new=90)
            healthy = [{"id": f"h{i}", "prompt": prompts[i % 6],
                        "max_new": n_new} for i in range(8)]
            hout = cl.call("streams", reqs=healthy)["results"]
            wait_for(lambda: door.stream_states().get(loris) == "orphaned",
                     90.0, "the slow client was never evicted")
            wait_for(lambda: not fab.has_work(), 60.0, "the fabric drained")
            cl.call("loris_close")
            engines = [r.engine for r in tr._replicas.values()]
            for e in engines:
                e._check_page_invariants()
            checks["loris_evicted"] = (
                all(r.get("tokens") == want[i % 6]
                    for i, r in enumerate(hout))
                and not any(e.has_work() for e in engines)
                and all(s is None for e in engines for s in e._slots))
            # which part failed, if one did: a healthy stream's first
            # token off 4d's (and its error event), or an engine not idle
            res["loris"] = {
                "streams_off": {r.get("id", i): (
                    first_diff(r.get("tokens") or [], want[i % 6]),
                    r.get("event") or r.get("wire"))
                    for i, r in enumerate(hout)
                    if r.get("tokens") != want[i % 6]},
                "engines_busy": [e.has_work() for e in engines]}
            if not checks["loris_evicted"]:
                log(f"front-door equality, slow client leg: "
                    f"{res['loris']}")
            # refusals: a deadline miss on this door
            dl = cl.call("streams", reqs=[{"id": "dl", "prompt": prompts[0],
                                           "max_new": n_new,
                                           "deadline_ms": 0.01}])[
                "results"][0]
            checks["deadline_typed"] = (
                dl.get("wire") is not None
                and dl["wire"]["kind"] == "deadline"
                and dl["wire"]["retry_after_ms"] is not None)
            checks["no_trip"] = br.trips == 0
            door.stop()
            # an overload: one slot behind a shedder with a hard cap
            reps = build_replicas(model, 1, max_batch=1, **kw)
            shed = LoadShedder(queue_depth_hi=2, queue_depth_lo=0,
                               queue_cap=3, breach_ticks=1,
                               retry_after_ms=123.0)
            door = FrontDoor(ServingFabric(InProcTransport(reps),
                                           shedder=shed)).start()
            ev = cl.retarget(door).call("flood", id="ov", n=8,
                                        prompt=prompts[0],
                                        max_new=n_new).get("event")
            checks["overload_typed"] = (ev is not None
                                        and ev["kind"] == "overloaded"
                                        and ev["retry_after_ms"] == 123.0)
            door.stop()
            del reps
            # a hang, on fresh replicas (their trees empty, so the long
            # prompts are handed off again): the prefill replica right
            # after the first handoff, under 3x the longest healthy op
            door, fab, br, tr = stack()
            budget = max(3.0 * longest, MIN_OP_BUDGET_S)
            hres, tripped_s, handed = hang_check(
                fab, br, tr, "r0", budget, cl.retarget(door),
                [{"id": f"hg{i}", "prompt": p, "max_new": n_new}
                 for i, p in enumerate(prompts)])
            st = fab.stats()
            checks["hang"] = (
                [r.get("tokens") for r in hres] == want
                and br.trips == 1 and tripped_s < 2 * budget
                and (st["readmitted"] + st["handoff_failures"]) >= 1)
            res["hang"] = {"longest_healthy_op_s": longest,
                           "budget_s": budget, "tripped_s": tripped_s,
                           "handed_off": len(handed),
                           "readmitted": st["readmitted"],
                           "handoff_failures": st["handoff_failures"]}
            door.stop()
            # the int8 arm, one request after another
            qmodel = quantize_model(model, kv_dtype="int8")
            door, fab, br, tr = stack(m=qmodel, max_batch=1, num_pages=32)
            qout = cl.retarget(door).call(
                "sequential", reqs=[{"id": f"q{i}", "prompt": prompts[i],
                                     "max_new": n_new} for i in range(3)])[
                "results"]
            qwant = RESULTS["fabric_equality"]["int8"]["streams"][:3]
            checks["int8_equal_single"] = [r.get("tokens") == w
                                           for r, w in zip(qout, qwant)]
            checks["int8_handoffs"] = fab.handoffs == 1
    finally:
        door.stop()
    res["checks"] = checks
    RESULTS["frontdoor_equality"] = res
    flat = [all(v) if isinstance(v, list) else bool(v)
            for v in checks.values()]
    log(f"front-door equality (llama3_8b widths, 2 layers, fp32; prefill + "
        f"both replicas behind a breaker, clients in their own process): "
        f"{checks}; hang {res['hang']}; {time.perf_counter() - t0:.1f} s")
    del model, qmodel, door, fab, br, tr
    empty_cache(torch, dev)
    if not all(flat):
        raise SystemExit(f"front-door equality failed: {res}")


# Phase 4b holds the card's int8 model (kernels) to the CPU's (plain
# versions), both fp32 over the same int8 weights. The two compute K/V in
# other summation orders (1e-6 apart), so a code whose value lies within
# that of a rounding boundary lands on the other side: those codes differ
# by exactly 1, at about 1e-4 of the written elements when each
# projection's output is perturbed by 2e-6 relative on the CPU (4096
# wide, 32 heads over 8 KV heads of 128, 2 layers). Each moves one K or V
# element by one quantization step (1/127 of its page's largest value);
# together they moved the logits by 9.4e-4 of their largest magnitude in
# that rehearsal. A wrong page, block or scale moves them by 1e-1 or
# more. The second layer's K/V come from attention over the first
# layer's codes, so the codes that differ there move its page scales
# (a page's absmax / 127) by up to about 1e-4 (1.34e-4 on the card,
# H100 80GB HBM3, 700 W); a scale from a wrong page is off by 1e-2 or
# more.
# The feature arm (chunks of 128 tokens attended over 256 positions, then
# verifies) is held per layer. Its first layer's codes come from the
# projections alone and keep QUANT_CODE_FRAC (card 1.6e-5). Its second
# layer's come from attention over the first layer's codes, where a code
# that differs moves a value by a whole quantization step, over a longer
# context than the prefill arm's. Beside each arm, phase 4b reads the
# CPU with every projection's output perturbed by 2e-6 relative
# (``perturbed``) against the plain CPU by the same measures: in the
# feature arm that flipped 6.0e-3 of the second layer's codes where the
# card flipped 4.0e-3 (H100 80GB HBM3, 700 W). Later layers are held to
# QUANT_CODE_FRAC_LATER, above that; every difference must still be 1,
# and the logits and scales keep their limits.
QUANT_LOGIT_TOL = 5e-3     # max |card - cpu| / max |cpu| over all steps
QUANT_CODE_FRAC = 1e-3     # codes that may differ (by 1) / codes written
QUANT_CODE_FRAC_LATER = 2e-2   # the feature arm, layers after the first
QUANT_SCALE_RTOL = 1e-3    # page scales, relative


def decode_teacher_forced(torch, model, hist, L):
    """``model``'s logits over a fixed history on its device: a paged
    prefill of hist[:L], then one decode step a token of the rest.
    Returns the logits (fp32, on the CPU) and the pools."""
    d = model.lm_head.device
    core = model.model
    pools, tables = core.alloc_paged_caches(1, 256, 128)
    h, _ = core.prefill_paged(torch.tensor(hist[None, :L], device=d),
                              pools, tables)
    logits = [model.logits(h[0, -1])]
    for i in range(L, len(hist)):
        h, _ = core.decode_step_paged(
            torch.tensor(hist[i:i + 1], device=d),
            torch.tensor([i], device=d), pools, tables)
        logits.append(model.logits(h[0, 0]))
    return (torch.stack(logits).float().cpu(),
            [[t.cpu() for t in p] for p in pools])


def features_teacher_forced(torch, model, ids, verify):
    """The engine features' entry points of ``model`` over fixed tokens,
    on its device: rows 0-3 prefilled from ``ids`` [8, 256] by two
    128-token chunks (offsets 0 and 128), rows 4-7 by one, four rows a
    chunk call (m = 512 in the products); then the two speculative
    verifies of ``verify`` [2, 8, 5] (m = 40), the second starting
    1 + (row % 5) past the first, over part of what the first wrote, as a
    verify after a partial acceptance does. Returns the logits of each
    chunk call's last token a row and of every verify token (fp32, on the
    CPU) and the pools."""
    d = model.lm_head.device
    core = model.model
    pools, tables = core.alloc_paged_caches(8, 512, 128)
    logits = []
    for rows, offset in ((slice(0, 4), 0), (slice(0, 4), 128),
                         (slice(4, 8), 0)):
        h, _ = core.prefill_chunk_paged(
            torch.tensor(ids[rows, offset:offset + 128], device=d), offset,
            pools, tables[rows])
        logits.append(model.logits(h[:, -1]))
    pos = np.array([256] * 4 + [128] * 4)
    for i, toks in enumerate(verify):
        at = pos + (1 + np.arange(8) % 5 if i else 0)
        h, _ = core.decode_verify_paged(torch.tensor(toks, device=d),
                                        torch.tensor(at, device=d), pools,
                                        tables)
        logits.append(model.logits(h).flatten(0, 1))
    return (torch.cat(logits).float().cpu(),
            [[t.cpu() for t in p] for p in pools])


def int8_agreement(lc, pc, lp, pp, per_layer=False):
    """The card's int8 logits and pools (lc, pc) against the CPU's (lp,
    pp), under phase 4b's limits (``per_layer``: the first layer's codes
    within QUANT_CODE_FRAC and the later layers' within
    QUANT_CODE_FRAC_LATER; otherwise all codes within QUANT_CODE_FRAC):
    {logit_err, codes_written, codes_differ, codes_differ_frac,
    codes_differ_frac_by_layer, codes_max_diff, scale_rel_err, ok}."""
    logit_err = float((lc - lp).abs().max() / lp.abs().max())
    written = differ = worst = 0
    scale_err = 0.0
    by_layer = []
    for layer_c, layer_p in zip(pc, pp):
        by_layer.append(differ)
        for codes_c, codes_p, s_c, s_p in ((layer_c[0], layer_p[0],
                                            layer_c[2], layer_p[2]),
                                           (layer_c[1], layer_p[1],
                                            layer_c[3], layer_p[3])):
            used = s_p > 0
            dc = (codes_c.int() - codes_p.int()).abs()[:, used]
            written += dc.numel()
            differ += int((dc > 0).sum())
            worst = max(worst, int(dc.max()))
            scale_err = max(scale_err, float(
                ((s_c - s_p).abs() / s_p.clamp_min(1e-30))[used].max()))
            if bool((s_c[~used] != 0).any()):
                worst = max(worst, 127)          # a page written on one side
    frac = differ / max(written, 1)
    # each layer writes as many codes
    by_layer = [(b - a) / max(written / len(pc), 1) for a, b in
                zip(by_layer, by_layer[1:] + [differ])]
    ok = {"logits": logit_err <= QUANT_LOGIT_TOL
          and bool(np.isfinite(lc.numpy()).all()),
          "codes": worst <= 1 and (
              by_layer[0] <= QUANT_CODE_FRAC
              and max(by_layer[1:], default=0) <= QUANT_CODE_FRAC_LATER
              if per_layer else frac <= QUANT_CODE_FRAC),
          "scales": scale_err <= QUANT_SCALE_RTOL}
    return {"logit_err": logit_err, "max_abs_logit": float(lp.abs().max()),
            "codes_written": written, "codes_differ": differ,
            "codes_differ_frac": frac, "codes_differ_frac_by_layer": by_layer,
            "codes_max_diff": worst, "scale_rel_err": scale_err, "ok": ok}


def perturbed(torch, run, model, rel=2e-6):
    """``run(model)`` with every projection's output perturbed by ``rel``
    relative (a seeded normal draw): on the CPU, the reading phase 4b's
    code limits are set against."""
    from paddle_tpu_torch.models import llama
    proj = llama._proj
    g = torch.Generator().manual_seed(0)

    def noisy(module, x, name, tp=None):
        y = proj(module, x, name, tp)
        return y * (1 + rel * torch.randn(y.shape, generator=g))
    llama._proj = noisy
    try:
        return run(model)
    finally:
        llama._proj = proj


def phase_quant_engine_equality(torch, pt, dev, make_cfg):
    """Phase 4b: Llama-3-8B widths at 2 layers, fp32 activations, int8
    weights and int8 KV, the same seeded weights on the card and on the
    CPU. Hard limits, for the paged prefill and decode (a 130-token
    prefill, then 8 decode steps of a fixed history) and for the engine
    features' entry points (prefill chunks and speculative verifies,
    ``features_teacher_forced``): teacher-forced logits within
    QUANT_LOGIT_TOL, and the pools' codes equal but for differences of 1
    at no more than QUANT_CODE_FRAC of the written elements, scales
    within QUANT_SCALE_RTOL. Reported only: the greedy-token agreement of
    the two engines (random weights have near-ties)."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_model
    cfg = make_cfg(num_hidden_layers=2, dtype="float32")
    t0 = time.perf_counter()
    native = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(7, dev))
    card = quantize_model(native, kv_dtype="int8")
    del native
    cpu = copy.deepcopy(card).to("cpu")
    hist = np.random.RandomState(11).randint(0, cfg.vocab_size, (139,))
    rs = np.random.RandomState(13)
    ids = rs.randint(0, cfg.vocab_size, (8, 256))
    verify = rs.randint(0, cfg.vocab_size, (2, 8, 5))
    runs = {"prefill_decode": lambda m: decode_teacher_forced(
                torch, m, hist, 130),
            "chunk_verify": lambda m: features_teacher_forced(
                torch, m, ids, verify)}
    checks = {}
    with torch.inference_mode():
        for label, run in runs.items():
            want = run(cpu)
            checks[label] = int8_agreement(*run(card), *want,
                                           per_layer=label == "chunk_verify")
            checks[label]["cpu_perturbed"] = int8_agreement(
                *perturbed(torch, run, cpu), *want)
    # the engines, on the card and on the CPU: greedy agreement, reported
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (37, 130)]
    n_new = 8
    streams = {}
    for name, model in (("card", card), ("cpu", cpu)):
        eng = ContinuousBatchingEngine(
            model, max_batch=2, page_size=128, max_len=512,
            generation_config=GenerationConfig(max_new_tokens=n_new),
            decode_block=4, async_depth=2)
        rids = [eng.submit(p) for p in prompts]
        out = eng.run()
        if not (eng.kv_quant and eng.kv_quant_ticks > 0):
            raise SystemExit("the quantized engine did not decode over "
                             "int8 pools")
        streams[name] = [out[r].tolist() for r in rids]
    agree = float(np.mean([np.mean(np.equal(a, b)) for a, b in
                           zip(streams["card"], streams["cpu"])]))
    res = {"logit_tol": QUANT_LOGIT_TOL, "code_frac_tol": QUANT_CODE_FRAC,
           "scale_rtol": QUANT_SCALE_RTOL, **checks,
           "greedy_agreement": agree, "streams": streams}
    RESULTS["quant_engine_equality"] = res
    for label, c in checks.items():
        ok = c["ok"]
        log(f"quantized engine equality, {label} (llama3_8b widths, 2 "
            f"layers, fp32, int8 weights and KV): teacher-forced logits "
            f"max|card-cpu|/max|cpu| {c['logit_err']:.3e} (tol "
            f"{QUANT_LOGIT_TOL}: {'ok' if ok['logits'] else 'FAIL'}); KV "
            f"codes differing {c['codes_differ']} of {c['codes_written']} "
            f"written ({c['codes_differ_frac']:.2e}; by layer "
            f"{['%.2e' % f for f in c['codes_differ_frac_by_layer']]}; tol "
            + (f"{QUANT_CODE_FRAC} first layer, {QUANT_CODE_FRAC_LATER} "
               f"later" if label == "chunk_verify" else
               f"{QUANT_CODE_FRAC}") + ", "
            f"largest difference {c['codes_max_diff']}: "
            f"{'ok' if ok['codes'] else 'FAIL'}); page scales rel err "
            f"{c['scale_rel_err']:.2e} (tol {QUANT_SCALE_RTOL}: "
            f"{'ok' if ok['scales'] else 'FAIL'}); the CPU with every "
            f"projection perturbed by 2e-6 against the CPU: "
            + ", ".join(f"{k} {c['cpu_perturbed'][k]}" for k in (
                "logit_err", "codes_differ_frac",
                "codes_differ_frac_by_layer", "codes_max_diff",
                "scale_rel_err")) + f" {card_line()}")
    log(f"quantized engine equality: engines' greedy agreement {agree:.3f} "
        f"(reported only); {time.perf_counter() - t0:.1f} s")
    del card, cpu
    empty_cache(torch, dev)
    bad = [label for label, c in checks.items() if not all(c["ok"].values())]
    if bad:
        raise SystemExit(f"the quantized model on the card differs from the "
                         f"plain path: {bad}")


def replay_drafts(torch, dev, streams, H):
    """A DraftProvider that proposes the plain path's own continuation:
    ``streams`` are (prompt, tokens) pairs; a row whose history starts
    with a stream's prompt gets the next ``k`` tokens of prompt + tokens
    after its ``hist_len`` (its last token past the stream's end or
    where no prompt matches). Every draft it makes before a stream ends
    is one the engine accepts, so the commit of accepted runs is driven
    on the card. Tensor ops on the device only, as the contract asks."""
    from paddle_tpu_torch.inference import DraftProvider
    seqs = np.full((len(streams), H), -1, np.int64)
    plen = np.zeros(len(streams), np.int64)
    for i, (p, t) in enumerate(streams):
        full = np.concatenate([p, t])[:H]
        seqs[i, :len(full)] = full
        plen[i] = len(p)
    seqs_d = torch.tensor(seqs, device=dev)               # [N, H]
    plen_d = torch.tensor(plen, device=dev)
    prompt_mask = torch.arange(H, device=dev)[None] < plen_d[:, None]

    class Replay(DraftProvider):
        def propose(self, history, hist_len, k):
            hist_len = hist_len.long()
            same = (history[:, None, :] == seqs_d[None]) | ~prompt_mask[None]
            match = same.all(-1) & (plen_d[None] <= hist_len[:, None])
            seq = seqs_d[match.long().argmax(1)]          # [B, H]
            idx = (hist_len[:, None]
                   + torch.arange(k, device=history.device)[None])
            toks = seq.gather(1, idx.clamp_max(H - 1))
            last = history.gather(1, (hist_len - 1).clamp(0, H - 1)[:, None])
            ok = match.any(1)[:, None] & (idx < H) & (toks >= 0)
            return torch.where(ok, toks, last)
    return Replay()


def hold_tick_without_sync(torch, dev, eng, chunk):
    """Run two speculative verify ticks (greedy and sampled) and one
    prefill chunk of ``eng`` (a live engine with a decoding slot 0) on
    the device under torch.cuda.set_sync_debug_mode("error"), their
    inputs uploaded before: a host sync in any of them raises."""
    with torch.inference_mode():
        eng._tables_dev = eng._to_device(eng.tables)
        ids = eng._to_device(np.zeros((1, chunk), np.int64))
        tables1 = eng._to_device(eng.tables[:1])
        sync(torch, dev)
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            eng._spec_tick(False)
            eng._spec_tick(True)
            eng._chunk_step(ids, chunk, tables1, chunk)
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        sync(torch, dev)


def phase_feature_equality(torch, pt, dev, make_cfg, page=128, shared=512,
                           lens=(300, 701), chunk=256, max_len=1024):
    """Phase 4c: the engine's features at Llama-3-8B widths, 2 layers,
    fp32, seeded weights (page_size ``page``, max_batch 4): the greedy
    tokens on the card must equal ``plain_greedy`` on the CPU for every
    request of a chunked-prefill run (three prompts of ``lens`` tokens,
    prefill_chunk ``chunk``), a prefix-cache run (six prompts sharing a
    ``shared``-token prefix, then one submitted again whole: the
    copy-on-write path), a spec_k = 4 run (n-gram drafts), a spec_k = 4
    run at async_depth 2 whose drafts replay the plain path's tokens
    (``replay_drafts``: accepted runs commit, eos and budgets end inside
    them; it must accept drafts) and a run with all three at async_depth
    2 (the resubmitted prompt ends on a page boundary: the tree holds
    whole pages); then two verify ticks (greedy and sampled) and one
    prefill chunk run under set_sync_debug_mode("error"). Keyword sizes
    are for a rehearsal on the CPU at a tiny config."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.models import LlamaForCausalLM
    cfg = make_cfg(num_hidden_layers=2, dtype="float32")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev,
                             generator=pt.generator(12, dev))
    ref = copy.deepcopy(model).to("cpu")
    rs = np.random.RandomState(12)
    V = cfg.vocab_size
    long = [rs.randint(0, V, (n,)).astype(np.int32)
            for n in rs.randint(lens[0], lens[1], size=3)]
    pre = rs.randint(0, V, (shared,)).astype(np.int32)
    ns = rs.randint(page // 8, page, size=6)
    # the first family prompt ends on a page boundary, so the whole of it
    # is in the tree (which holds whole pages) once it has been served
    ns[0] = page - shared % page
    family = [np.concatenate([pre, rs.randint(0, V, (n,)).astype(np.int32)])
              for n in ns]
    n_new = 8
    with torch.inference_mode():
        want = {id(p): plain_greedy(torch, ref, p, n_new, page)
                for p in long + family}
    kw = dict(max_batch=4, page_size=page, max_len=max_len)
    # the replay run: drafts of the plain path's own tokens, so accepted
    # runs commit; eos is the first request's 4th token, inside the run
    # its first verify accepts, and the other requests' budgets run out
    # inside an accepted run
    eos = int(want[id(long[0])][3])
    replay = replay_drafts(torch, dev, [(p, want[id(p)]) for p in
                                        long + family], max_len)
    runs = {"chunked": (dict(chunked_prefill=True, prefill_chunk=chunk),
                        [long], None),
            "prefix": (dict(prefix_cache=True), [family, family[:1]], None),
            "spec4": (dict(spec_k=4), [long + family[:2]], None),
            "spec4_replay": (dict(spec_k=4, draft_provider=replay,
                                  async_depth=2), [long + family[:2]], eos),
            "all": (dict(chunked_prefill=True, prefill_chunk=chunk,
                         prefix_cache=True, spec_k=4, async_depth=2),
                    [long + family, family[:1]], None)}
    res, bad = {}, []
    eng = None
    for name, (feats, rounds, stop) in runs.items():
        eng = ContinuousBatchingEngine(
            model, generation_config=GenerationConfig(
                max_new_tokens=n_new, eos_token_id=stop), **kw, **feats)
        equal = []
        for batch in rounds:
            rids = [eng.submit(p) for p in batch]
            out = eng.run()
            for r, p in zip(rids, batch):
                w = want[id(p)]
                if stop is not None and (w == stop).any():
                    w = w[:int(np.argmax(w == stop)) + 1]
                equal.append(bool(np.array_equal(out[r], w)))
        if eng._prefix is not None:
            eng._check_page_invariants()
        res[name] = {"equal": equal, "stats": eng.stats(),
                     "prefix": eng.prefix_stats(), "spec": eng.spec_stats()}
        if not all(equal) or (eng._prefix is not None
                              and eng.prefix_cow_copies < 1) or (
                feats.get("draft_provider") is replay
                and eng.spec_tokens_accepted < 1):
            bad.append(name)
        log(f"feature equality {name} (llama3_8b widths, 2 layers, fp32, "
            f"page {page}): {sum(equal)}/{len(equal)} requests equal the "
            f"plain path; prefix {eng.prefix_stats()}; spec "
            f"{eng.spec_stats()}")
    # the last engine ("all") again: a request decoding in slot 0, then a
    # verify tick and a chunk step with no host sync
    eng.submit(long[0][:page + 1])
    with torch.inference_mode():
        eng._admit()
        while not eng._decode_ready(eng._slots[0]):
            eng._prefill_tick()
    hold_tick_without_sync(torch, dev, eng, chunk)
    log(f"feature equality: two verify ticks (B=4, spec_k=4; greedy and "
        f"sampled) and a "
        f"{chunk}-token prefill chunk ran under set_sync_debug_mode('error') "
        f"without a host sync; {time.perf_counter() - t0:.1f} s")
    RESULTS["feature_equality"] = res
    del eng, model, ref
    empty_cache(torch, dev)
    if bad:
        raise SystemExit(f"engine features differ from the plain path: "
                         f"{bad}: {res}")


# Phases 5-5c: the engine's settings (the warm-up's too), each request's
# new tokens, phase 5's prompt lengths, phase 5c's shared system prompt
# and its suffixes, its prefill chunk and draft length, and the position
# of the profiled context-attention ticks
SERVE_KW = dict(max_batch=8, page_size=128, max_len=2048, decode_block=8,
                async_depth=2)
SERVE_NEW = 64
PROMPT_LENS = (128, 1536)
SYSTEM_LEN, SUFFIX_LENS = 1024, (128, 512)
CHUNK, SPEC_K = 512, 4
CTX_START = 1024


def serving_traffic(V):
    """Phase 5's 16 prompts (numpy seed 8); no second round."""
    rs = np.random.RandomState(8)
    lens = rs.randint(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=16)
    return [rs.randint(0, V, (n,)).astype(np.int32) for n in lens], ()


def prefix_traffic(V):
    """16 prompts, each one shared system prompt plus a unique suffix
    (numpy seed 12); then the last 8 again as prompt + output (up to the
    last whole page)."""
    rs = np.random.RandomState(12)
    system = rs.randint(0, V, (SYSTEM_LEN,)).astype(np.int32)
    lens = rs.randint(SUFFIX_LENS[0], SUFFIX_LENS[1] + 1, size=16)
    return ([np.concatenate([system, rs.randint(0, V, (n,)).astype(
        np.int32)]) for n in lens], range(8, 16))


# phase 5c: (label, engine features, traffic, kernels that must launch)
FEATURE_RUNS = (
    ("serving_chunked", {"chunked_prefill": True, "prefill_chunk": CHUNK},
     serving_traffic, SERVING_KERNELS),
    ("serving_prefix", {"prefix_cache": True}, prefix_traffic,
     SERVING_KERNELS),
    ("serving_spec", {"spec_k": SPEC_K}, serving_traffic,
     ("rms_norm", "fused_rope")))
QUANT_FEATURE_RUN = ("quantized_serving_features",
                     {"chunked_prefill": True, "prefill_chunk": CHUNK,
                      "prefix_cache": True, "spec_k": SPEC_K},
                     prefix_traffic,
                     ("rms_norm", "fused_rope", "int8_matmul_wgmma",
                      "int8_matmul_decode"))


def serve_run(torch, dev, model, label, kernels, feats=None,
              traffic=serving_traffic):
    """One serving run of phases 5, 5b and 5c over ``model``: a warm-up
    engine on two of the prompts, then ``traffic``'s 16 prompts and its second round (the
    requests it names again, as prompt + output up to the last whole
    page: full prefix hits), SERVE_NEW new tokens each and every 4th
    sampled, through ContinuousBatchingEngine(**SERVE_KW, **feats);
    launch counts reset just before and read just after. Fails unless
    every request succeeded (all its tokens, each in the vocabulary),
    the logits are finite, every kernel of ``kernels`` launched and,
    with the features on, the prefix cache hit (hit rate > 0, a copy on
    write for each request of the second round) and speculation scored
    drafts. Returns the run's numbers and the first round's streams."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.ops.kernels import _build
    V = model.cfg.vocab_size
    feats = feats or {}
    sampled = GenerationConfig(do_sample=True, temperature=0.8, top_k=40,
                               top_p=0.95)
    kw = dict(SERVE_KW, generation_config=GenerationConfig(seed=0), **feats)
    prompts, again = traffic(V)
    # warm-up (cuBLAS handles, allocator) on the first two prompts, 4
    # tokens each, the second sampled, outside the counted run
    warm = ContinuousBatchingEngine(model, **kw)
    warm.submit(prompts[0], max_new_tokens=4)
    warm.submit(prompts[1], max_new_tokens=4, generation_config=sampled)
    warm.run()
    del warm
    sync(torch, dev)
    gcs = [sampled if i % 4 == 3 else None for i in range(len(prompts))]
    eng = ContinuousBatchingEngine(model, **kw)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=SERVE_NEW, generation_config=g)
            for p, g in zip(prompts, gcs)]
    out = eng.run()
    # the conversation (prompt + output) up to its last whole page: the
    # tree holds whole pages only, so that much is a full hit
    page = SERVE_KW["page_size"]
    convs = [np.concatenate([prompts[i], out[rids[i]]]) for i in again]
    sent = rids + [eng.submit(c[:len(c) // page * page],
                              max_new_tokens=SERVE_NEW,
                              generation_config=gcs[i])
                   for i, c in zip(again, convs)]
    if convs:
        out.update(eng.run())
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    ok = [r for r in sent if r in out and len(out[r]) == SERVE_NEW
          and int(out[r].min()) >= 0 and int(out[r].max()) < V]
    logits_ok = bool(torch.isfinite(eng._state["logits"].float()).all())
    n_tok = sum(len(out[r]) for r in sent if r in out)
    lat = eng.latency_stats()
    pre, spec = eng.prefix_stats(), eng.spec_stats()
    pool_bytes = sum(t.numel() * t.element_size() for p in eng.pools
                     for t in p)
    model_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    info = {"requests_sent": len(sent), "requests_succeeded": len(ok),
            "requests_failed": len(sent) - len(ok),
            "prompt_tokens": int(sum(len(p) for p in prompts)),
            "generated_tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall, "latency": lat,
            "stats": eng.stats(), "prefix": pre, "spec": spec,
            "launches": launches, "features": feats,
            "model_bytes": model_bytes, "kv_pool_bytes": pool_bytes,
            "peak_memory_bytes": peak, "kv_quant_ticks": eng.kv_quant_ticks}
    RESULTS[label] = info
    log(f"{label} ({feats}): requests sent {len(sent)}, succeeded "
        f"{len(ok)}, failed {len(sent) - len(ok)}; prompt tokens "
        f"{info['prompt_tokens']}, generated {n_tok} in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s; TTFT p50 "
        f"{lat['ttft_p50_s'] * 1e3:.1f} ms p99 {lat['ttft_p99_s'] * 1e3:.1f}"
        f" ms; ITL p50 {lat.get('itl_p50_s', float('nan')) * 1e3:.2f} ms "
        f"p99 {lat.get('itl_p99_s', float('nan')) * 1e3:.2f} ms; "
        + (f"prefix hit tokens {pre['prefix_hit_tokens']:.0f}, hit rate "
           f"{pre.get('prefix_hit_rate', 0.0):.4f}, COW copies "
           f"{pre['prefix_cow_copies']:.0f}; " if pre else "")
        + (f"acceptance rate {spec.get('spec_accept_rate', 0.0):.4f}, mean "
           f"accepted length {spec.get('spec_mean_accepted_len', 0.0):.4f}; "
           if spec else "")
        + f"model bytes {model_bytes}, KV-pool bytes {pool_bytes}, peak "
        f"memory {peak}; stats {eng.stats()} {card_line()}")
    log(f"{label} launches: {launches} {card_line()}")
    streams = [out[r] for r in rids]
    del eng
    empty_cache(torch, dev)
    missing = [k for k in kernels if launches.get(k, 0) <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the {label} path: "
                         f"{missing}")
    if len(ok) != len(sent) or not logits_ok:
        raise SystemExit(f"{label}: {len(sent) - len(ok)} requests failed "
                         f"(logits finite {logits_ok})")
    if pre and not (pre.get("prefix_hit_rate", 0.0) > 0
                    and pre["prefix_cow_copies"] >= len(convs) > 0):
        raise SystemExit(f"{label}: the prefix cache did not hit: {pre}")
    if spec and "spec_accept_rate" not in spec:
        raise SystemExit(f"{label}: no draft was scored: {spec}")
    return info, streams


CROSSOVER_CTX = (128, 256, 512, 1024, 2048, 4096, 8192)


def crossover_sweep(torch, dev, model, label):
    """Phase 3c: one decode step of ``model`` (``decode_step_paged`` and
    the head) at B = 8 rows at context c, for c in CROSSOVER_CTX, under
    the paged route and the dense route (``force_decode_impl``), over a
    table that covers exactly c tokens a row (the dense route gathers
    the whole table: this is its best case); CUDA events, median of 10
    after 2 warm-ups. The step is host-bound (its launches take longer
    to enqueue than the card takes to run them), so its times are
    printed and not used. The two routes differ only in the attention,
    so the crossover comes from one layer's attention alone, timed on
    the device (the paged kernel against ``paged_decode_dense``, L2
    flushed, the host given a head start, median of 25): the largest
    context up to which the dense route was faster at every context
    swept (0: paged at every context). Fails when that is not the
    port's ``paged_decode_crossover()``."""
    from paddle_tpu_torch.ops.attention import (force_decode_impl,
                                                paged_decode_attention,
                                                paged_decode_crossover,
                                                paged_decode_dense)
    core = model.model
    B, page = SERVE_KW["max_batch"], SERVE_KW["page_size"]
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    rows, crossover, dense_ahead = [], 0, True
    for ctx in CROSSOVER_CTX:
        pools, tables = core.alloc_paged_caches(B, ctx, page)
        tok = torch.zeros((B,), dtype=torch.int64, device=dev)
        pos = torch.full((B,), ctx - 1, dtype=torch.int64, device=dev)
        row = {"ctx": ctx}
        with torch.inference_mode():
            for impl in ("paged", "dense"):
                def step():
                    with force_decode_impl(impl):
                        h, _ = core.decode_step_paged(tok, pos, pools,
                                                      tables)
                        return model.logits(h[:, 0])
                for _ in range(2):
                    step()
                times = []
                for _ in range(10):
                    sync(torch, dev)
                    span = DeviceSpan(torch, dev)
                    step()
                    times.append(span.end())
                row[f"{impl}_step_ms"] = statistics.median(times)
            kv = pools[0]
            q = torch.randn((B, model.cfg.num_attention_heads,
                             model.cfg.head_dim), device=dev).to(
                                 core.embed_tokens.dtype)
            scales = ({"k_scales": kv[2], "v_scales": kv[3]}
                      if len(kv) == 4 else {})
            for impl, fn in (("paged", paged_decode_attention),
                             ("dense", paged_decode_dense)):
                row[f"{impl}_attention_ms"] = timed_ms(
                    torch, lambda: fn(q, kv[0], kv[1], tables, pos, **scales),
                    flush)
        dense_ahead = (dense_ahead and row["dense_attention_ms"]
                       < row["paged_attention_ms"])
        if dense_ahead:
            crossover = ctx
        rows.append(row)
        del pools, tables
        empty_cache(torch, dev)
    del flush
    for r in rows:
        log(f"{label} crossover sweep, ctx {r['ctx']}: decode step paged "
            f"{r['paged_step_ms']:.3f} ms, dense {r['dense_step_ms']:.3f} ms;"
            f" one layer's attention paged {r['paged_attention_ms'] * 1e3:.1f}"
            f" us, dense {r['dense_attention_ms'] * 1e3:.1f} us {card_line()}")
    step_dense = sum(r["dense_step_ms"] < r["paged_step_ms"] for r in rows)
    default = paged_decode_crossover()
    log(f"{label}: the crossover the attention's device times imply is "
        f"{crossover} tokens (B={B}, page {page}); the port's default "
        f"paged_decode_crossover() = {default}; the host-bound whole step "
        f"was faster dense at {step_dense} of {len(rows)} contexts "
        f"(reported only) {card_line()}")
    tuned = tune_crossover(crossover)
    log(f"{label}: the crossover {crossover} written to a user TuneDB "
        f"({tuned['path']}, key {tuned['key']}): paged_decode_crossover() "
        f"read back {tuned['read_back']}")
    RESULTS[label + "_crossover"] = {"rows": rows, "crossover": crossover,
                                     "default": default,
                                     "step_dense_faster": step_dense,
                                     "tune_db": tuned}
    if crossover != default:
        raise SystemExit(f"{label}: the measured crossover {crossover} is "
                         f"not the port's default {default}")
    if tuned["read_back"] != crossover:
        raise SystemExit(f"{label}: paged_decode_crossover() read "
                         f"{tuned['read_back']} from the TuneDB holding "
                         f"{crossover}")
    return crossover


def tune_crossover(crossover: int) -> dict:
    """3c's result into a user TuneDB (``chiprun_out/tune_db.json``
    through ``PT_TUNE_DB``, the JAX package's key for this card), read
    back through ``paged_decode_crossover()``; the environment and the
    process's TuneDB are restored after."""
    from paddle_tpu_torch.observability.costs import current_device_kind
    from paddle_tpu_torch.ops.attention import paged_decode_crossover
    from paddle_tpu_torch.ops.kernels import autotune
    os.makedirs(ROOT_OUT, exist_ok=True)
    path = os.path.join(ROOT_OUT, "tune_db.json")
    key = autotune.TuneDB.key("paged_decode_crossover",
                              current_device_kind(), "any")
    old = os.environ.get("PT_TUNE_DB")
    os.environ["PT_TUNE_DB"] = path
    try:
        db = autotune.TuneDB(user_path=path)
        db.record(key, {"ctx": int(crossover)})
        db.save()
        autotune.get_db().reload()
        got = paged_decode_crossover()
    finally:
        if old is None:
            os.environ.pop("PT_TUNE_DB", None)
        else:
            os.environ["PT_TUNE_DB"] = old
        autotune.get_db().reload()
    return {"path": path, "key": key, "read_back": got}


SAMPLED_KNOBS = {"do_sample": True, "temperature": 0.8, "top_k": 40,
                 "top_p": 0.95}
FABRIC_THRESHOLD = 512


def handoff_alone(torch, dev, model, src, prompt, reps=3):
    """One handoff of ``prompt``'s pages from engine ``src`` on the idle
    card, after phase 5d's window (the window itself times no handoff:
    a wait there would drain the replicas' queued decode work): host ms
    of ``serialize_pages`` (the gather and copy to the host, then the
    sha256), of the sha256 alone over the same payload, and of
    ``adopt_pages`` into a fresh engine with the prefix cache (the
    sha256 check, then the copy up), its copies waited for; medians of
    ``reps``. Returns ms a page."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.inference.serving import _payload_sha256
    ext, hsh, adp = [], [], []
    for _ in range(reps):
        sync(torch, dev)
        t0 = time.perf_counter()
        pay = src.serialize_pages(prompt)
        ext.append((time.perf_counter() - t0) * 1e3)
        if pay is None:
            raise SystemExit("handoff_alone: the prefill replica holds no "
                             "page of the prompt")
        t0 = time.perf_counter()
        _payload_sha256(pay["tokens"], pay["kv"], pay.get("scales"))
        hsh.append((time.perf_counter() - t0) * 1e3)
        n = pay["shape"][3]
        dst = ContinuousBatchingEngine(
            model, max_batch=1, page_size=SERVE_KW["page_size"],
            max_len=SERVE_KW["max_len"], num_pages=n, prefix_cache=True)
        sync(torch, dev)
        t0 = time.perf_counter()
        if len(dst.adopt_pages(pay)) != n:
            raise SystemExit("handoff_alone: the fresh engine did not adopt "
                             "every page")
        sync(torch, dev)
        adp.append((time.perf_counter() - t0) * 1e3)
        del dst
    med = statistics.median
    return {"pages": n, "bytes_a_page": pay["kv"].nbytes // n,
            "extract_ms_per_page": med(ext) / n,
            "sha256_ms_per_page": med(hsh) / n,
            "adopt_ms_per_page": med(adp) / n}


def fabric_run(torch, dev, model, label, kernels, serve_label, n_req=16):
    """Phase 5d: the first ``n_req`` of phase 5's 16 requests (SERVE_NEW
    tokens, every 4th sampled) through ServingFabric(InProcTransport(
    build_replicas(model, 2, roles=["prefill", "both"], **SERVE_KW)),
    policy="affinity", disagg_threshold_tokens=FABRIC_THRESHOLD), after
    a warm-up fabric on two prompts; launch counts reset just before and
    read just after. Prints requests sent / succeeded / failed, tokens/s,
    TTFT and ITL, requests handed off, pages exported / adopted, each
    replica's attention-route ticks and launches, beside phase
    ``serve_label``'s numbers of the same call; then one handoff timed
    alone (``handoff_alone``). Fails on a failed request, a handoff that
    failed or did not happen (every prompt at or over the threshold is
    handed off), a replica marked down or a request re-admitted, no
    adopted page, or a kernel of ``kernels`` not launched."""
    from paddle_tpu_torch.inference import GenerationConfig
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.serving_fabric import (InProcTransport,
                                                 ServingFabric,
                                                 build_replicas)
    V = model.cfg.vocab_size
    prompts = serving_traffic(V)[0][:n_req]

    def fabric():
        tr = InProcTransport(build_replicas(
            model, 2, roles=["prefill", "both"],
            generation_config=GenerationConfig(seed=0), **SERVE_KW))
        return tr, ServingFabric(tr, policy="affinity",
                                 disagg_threshold_tokens=FABRIC_THRESHOLD)
    tr, fab = fabric()            # warm-up: one handed-off prompt, one not
    long_ = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    fab.submit(prompts[long_], 4)
    fab.submit(prompts[0], 4, knobs=SAMPLED_KNOBS)
    fab.run()
    del tr, fab
    empty_cache(torch, dev)
    sync(torch, dev)
    tr, fab = fabric()
    _build.reset_launches()
    t0 = time.perf_counter()
    fids = [fab.submit(p, SERVE_NEW,
                       knobs=SAMPLED_KNOBS if i % 4 == 3 else None)
            for i, p in enumerate(prompts)]
    out = fab.run()
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    ok = [f for f in fids if out.get(f) is not None
          and len(out[f]) == SERVE_NEW and int(out[f].min()) >= 0
          and int(out[f].max()) < V]
    n_tok = sum(len(out[f]) for f in fids if out.get(f) is not None)
    lat = fab.latency_stats()
    st = fab.stats()
    engines = {r.name: r.engine for r in tr._replicas.values()}
    exported = sum(e.pages_exported for e in engines.values())
    adopted = sum(e.pages_adopted for e in engines.values())
    long_want = sum(len(p) >= FABRIC_THRESHOLD for p in prompts)
    info = {"requests_sent": len(fids), "requests_succeeded": len(ok),
            "requests_failed": len(fids) - len(ok),
            "generated_tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall, "latency": lat,
            "handed_off": fab.handoffs, "long_prompts": long_want,
            "handoff_failures": fab.handoff_failures,
            "replicas_dead": st["replicas_dead"],
            "readmitted": st["readmitted"],
            "pages_exported": exported, "pages_adopted": adopted,
            "attn_path_ticks": {n: dict(e.attn_path_ticks)
                                for n, e in engines.items()},
            "routed": st["routed"], "launches": launches,
            "streams": [None if out.get(f) is None else out[f].tolist()
                        for f in fids]}
    src = next(r.engine for r in tr._replicas.values()
               if r.role == "prefill")
    info["handoff_alone"] = handoff_alone(torch, dev, model, src,
                                          prompts[long_])
    RESULTS[label] = info
    base = RESULTS[serve_label]
    blat = base["latency"]
    ha = info["handoff_alone"]
    log(f"{label} (prefill + both replicas, affinity, disagg at "
        f"{FABRIC_THRESHOLD} tokens): requests sent {len(fids)}, succeeded "
        f"{len(ok)}, failed {len(fids) - len(ok)}; generated {n_tok} in "
        f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s; TTFT p50 "
        f"{lat['ttft_p50_s'] * 1e3:.1f} ms p99 {lat['ttft_p99_s'] * 1e3:.1f}"
        f" ms; ITL p50 {lat['itl_p50_s'] * 1e3:.2f} ms p99 "
        f"{lat['itl_p99_s'] * 1e3:.2f} ms; handed off {fab.handoffs} of "
        f"{long_want} prompts at or over the threshold (failures "
        f"{fab.handoff_failures}, replicas down {st['replicas_dead']}, "
        f"re-admitted {st['readmitted']}); pages exported {exported}, "
        f"adopted {adopted}; attention route ticks {info['attn_path_ticks']}"
        f"; routed {info['routed']} {card_line()}")
    log(f"{label}: one handoff alone on the idle card ({ha['pages']} pages "
        f"of {ha['bytes_a_page']} bytes, median of 3): extract "
        f"{ha['extract_ms_per_page']:.3f} ms a page (of which sha256 "
        f"{ha['sha256_ms_per_page']:.3f}), adopt "
        f"{ha['adopt_ms_per_page']:.3f} ms a page (its sha256 check the "
        f"same) {card_line()}")
    log(f"{label} ({len(fids)} requests) beside {serve_label} "
        f"({base['requests_sent']}; same call): {n_tok / wall:.1f} vs "
        f"{base['tokens_per_s']:.1f} tokens/s; TTFT p50 "
        f"{lat['ttft_p50_s'] * 1e3:.1f} vs {blat['ttft_p50_s'] * 1e3:.1f} ms;"
        f" ITL p50 {lat['itl_p50_s'] * 1e3:.2f} vs "
        f"{blat['itl_p50_s'] * 1e3:.2f} ms, p99 "
        f"{lat['itl_p99_s'] * 1e3:.2f} vs {blat['itl_p99_s'] * 1e3:.2f} ms")
    log(f"{label} launches: {launches} {card_line()}")
    del tr, fab, engines, src
    empty_cache(torch, dev)
    missing = [k for k in kernels if launches.get(k, 0) <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the {label} path: "
                         f"{missing}")
    if (len(ok) != len(fids) or adopted <= 0
            or info["handed_off"] != long_want or info["handoff_failures"]
            or info["replicas_dead"] or info["readmitted"]):
        raise SystemExit(f"{label}: {len(fids) - len(ok)} requests failed, "
                         f"{adopted} pages adopted, handoffs or replicas "
                         f"failed; {info}")
    return launches


def first_diff(a, b):
    """The first index where token lists ``a`` and ``b`` differ (None
    when equal)."""
    if a == b:
        return None
    return next((i for i, (x, y) in enumerate(zip(a or [], b))
                 if x != y), min(len(a or []), len(b)))


def timed_sentry(sn, rules, **kw):
    """An SloSentry that also sums the host time of the ticks that
    evaluated (``tick_s``; a rate-limited tick returns at once)."""
    class Timed(sn.SloSentry):
        tick_s = 0.0

        def tick(self, now=None):
            n, t0 = self.ticks, time.perf_counter()
            out = super().tick(now)
            if self.ticks > n:
                self.tick_s += time.perf_counter() - t0
            return out
    return Timed(rules, **kw)


# the router-level latency rules of the 5e sentry: rule -> the router's
# latency_stats() key its gauge mirrors
ROUTER_RULES = {"fabric_ttft_p99_ceiling": "ttft_p99_s",
                "frontdoor_ttft_p99_ceiling": "ttft_p99_s",
                "fabric_itl_p99_ceiling": "itl_p99_s"}


def frontdoor_run(torch, dev, model, label, kernels, base_label, n_hang=16):
    """Phase 5e: phase 5's 16 requests (SERVE_NEW tokens, every 4th
    sampled) from 16 concurrent FabricClients in the client process
    through FrontDoor(ServingFabric(BreakerTransport(InProcTransport(
    build_replicas(model, 2, roles=["prefill", "both"], **SERVE_KW))),
    policy="affinity", disagg_threshold_tokens=FABRIC_THRESHOLD)), after
    a warm-up stack of its own (as 5d's), with the metrics registry on
    (its engines built with ``cost_census=False``: no decode block of the
    window runs under a cost census), the SLO sentry installed (serving, fabric and front-door packs at
    their defaults, ``min_interval_s=1.0``) and the window inside
    ``profiler.serving_trace`` and traced by the request tracer (its
    completed traces kept for 17(c), written under
    ``chiprun_out/frontdoor_trace/requests``); launch counts reset just
    before and read just after. Prints tokens/s, TTFT and ITL at the client (stamped when
    a token's event reaches it) and at the router, beside phase
    ``base_label``'s of the same call; the sentry's ticks, their mean ms
    and incidents by rule; host ms and count per span name; breaker trips
    and the longest healthy op; launches by kernel. Fails on a failed
    request, a greedy stream unequal to ``base_label``'s, a trip, a span
    name of SERVING_EVENTS missing, a kernel of ``kernels`` not launched,
    or a router-level latency rule whose incident does not follow the
    router's p99 against its ceiling: after the window the router's
    percentiles are published (the door's path never calls ``run()``,
    which does that) and the sentry evaluates the final state for each
    rule's ``breach_for`` windows.

    Then the hang leg, on fresh replicas of the same kind (their prefix
    trees empty: on the window's replicas every long prompt would be a
    full prefix hit, and nothing would be handed off): the first
    ``n_hang`` requests, the prefill replica hung right after the 4th
    handoff under an op budget of 3x the window's longest healthy op
    (at least MIN_OP_BUDGET_S). The breaker must trip once, within 2x
    the budget; the requests the prefill replica held go to the "both"
    replica; once released, the replica is readmitted. Greedy streams of
    prompts that took the same path as in 5d (short, or handed off)
    equal 5d's; a long prompt served cold (re-admitted, or its handoff
    failed) runs another arithmetic in bf16 (a full prefill where 5d
    prefilled the suffix over adopted pages) and must equal one engine
    serving it cold. Returns the window's launches."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.inference import GenerationConfig
    from paddle_tpu_torch.observability import REGISTRY
    from paddle_tpu_torch.observability import sentry as sn
    from paddle_tpu_torch.observability.tracing import TRACER
    from paddle_tpu_torch.ops.kernels import _build
    V = model.cfg.vocab_size
    prompts = [p.tolist() for p in serving_traffic(V)[0]]
    base = RESULTS[base_label]
    want = base["streams"]
    names, roles = ["r0", "r1"], ["prefill", "both"]
    kw = dict(generation_config=GenerationConfig(seed=0), **SERVE_KW)
    greedy = [i for i in range(len(prompts)) if i % 4 != 3]

    def reqs(tag, n=len(prompts)):
        return [{"id": f"{tag}{i}", "prompt": prompts[i], "max_new": SERVE_NEW,
                 "knobs": SAMPLED_KNOBS if i % 4 == 3 else None}
                for i in range(n)]

    def stack(**extra):
        return frontdoor_stack(model, names, roles, FABRIC_THRESHOLD,
                               "affinity", **kw, **extra)

    def failed(results):
        return [r["id"] for r in results
                if r.get("tokens") is None or len(r["tokens"]) != SERVE_NEW
                or min(r["tokens"]) < 0 or max(r["tokens"]) >= V]

    long_ = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    door, fab, br, tr = stack()
    info: dict = {}
    try:
        with Clients(door) as cl:
            warm = cl.call("streams", reqs=[
                {"id": "w0", "prompt": prompts[long_], "max_new": 4},
                {"id": "w1", "prompt": prompts[0], "max_new": 4,
                 "knobs": SAMPLED_KNOBS}])["results"]
            door.stop()
            del door, fab, br, tr
            empty_cache(torch, dev)
            # no cost census: a census traces a whole decode block, a
            # stall that would land in the window's latencies
            door, fab, br, tr = stack(cost_census=False)
            rules = (sn.serving_rules() + sn.fabric_rules(replicas=names)
                     + sn.frontdoor_rules(replicas=names))
            sentry = timed_sentry(sn, rules, min_interval_s=1.0)
            REGISTRY.reset()
            REGISTRY.enable()
            sn.install(sentry)
            sync(torch, dev)
            _build.reset_launches()
            # the window runs traced: 17(c) attributes its stitched traces
            TRACER.enable(dir=os.path.join(ROOT_OUT, "frontdoor_trace",
                                           "requests"))
            with profiler.serving_trace(
                    os.path.join(ROOT_OUT, "frontdoor_trace"),
                    worker_name="frontdoor") as prof:
                out = cl.retarget(door).call("streams", reqs=reqs("f"))[
                    "results"]
                sync(torch, dev)
            launches = dict(_build.LAUNCHES)
            FRONTDOOR_TRACES[:] = TRACER.take_completed()
            TRACER.disable()
            ticks, tick_s = sentry.ticks, sentry.tick_s
            with door._flock:
                lat = fab.publish_metrics()
                now = time.monotonic()
                for k in range(max(r.breach_for for r in rules)):
                    sentry.tick(now=now + sentry.min_interval_s * (k + 1))
                st = fab.stats()
            sn.uninstall()
            REGISTRY.disable()
            fired: dict = {}
            for inc in sentry.incidents:
                fired[inc.rule] = fired.get(inc.rule, 0) + 1
            ceilings = {r.name: r.ceiling for r in rules
                        if r.name in ROUTER_RULES}
            iff = {name: ((name in fired)
                          == (lat.get(key, 0.0) > ceilings[name]))
                   for name, key in ROUTER_RULES.items()}
            spans: dict = {}
            for ev in prof.result.events:
                ms, n = spans.get(ev.name, (0.0, 0))
                spans[ev.name] = (ms + (ev.end_ns - ev.start_ns) / 1e6, n + 1)
            client = client_latency(out)
            longest = tr.longest()
            longest_poll = tr.longest(("poll",))
            budget = max(3.0 * longest, MIN_OP_BUDGET_S)
            info = {"requests_sent": len(out), "failed": failed(out),
                    "warm_failed": [r["id"] for r in warm
                                    if len(r.get("tokens") or ()) != 4],
                    "client": client, "router": lat,
                    "greedy_equal_5d": [out[i].get("tokens") == want[i]
                                        for i in greedy],
                    "handed_off": st["handoffs"],
                    "sentry": {"ticks": ticks,
                               "tick_ms_mean": (tick_s / ticks * 1e3
                                                if ticks else None),
                               "incidents": fired, "router_rules_iff": iff,
                               "ceilings": ceilings},
                    "spans": {k: {"ms": v[0], "count": v[1]}
                              for k, v in sorted(spans.items())},
                    "trips": br.trips, "longest_healthy_op_s": longest,
                    "longest_healthy_poll_s": longest_poll,
                    "launches": launches}
            missing_spans = sorted(set(profiler.SERVING_EVENTS) - set(spans))
            blat = base["latency"]
            log(f"{label} (front door over prefill + both replicas behind a "
                f"breaker, 16 clients in their own process): requests sent "
                f"{len(out)}, failed {len(info['failed'])}; at the client "
                f"{client['tokens']} tokens in {client['wall_s']:.3f} s = "
                f"{client['tokens_per_s']:.1f} tokens/s, TTFT p50 "
                f"{client['ttft_p50_s'] * 1e3:.1f} ms p99 "
                f"{client['ttft_p99_s'] * 1e3:.1f} ms, ITL p50 "
                f"{client['itl_p50_s'] * 1e3:.2f} ms p99 "
                f"{client['itl_p99_s'] * 1e3:.2f} ms; at the router TTFT "
                f"p50 {lat['ttft_p50_s'] * 1e3:.1f} ms p99 "
                f"{lat['ttft_p99_s'] * 1e3:.1f} ms, ITL p50 "
                f"{lat['itl_p50_s'] * 1e3:.2f} ms p99 "
                f"{lat['itl_p99_s'] * 1e3:.2f} ms; {base_label} (same call) "
                f"{base['tokens_per_s']:.1f} tokens/s, TTFT p50 "
                f"{blat['ttft_p50_s'] * 1e3:.1f} ms p99 "
                f"{blat['ttft_p99_s'] * 1e3:.1f} ms, ITL p50 "
                f"{blat['itl_p50_s'] * 1e3:.2f} ms p99 "
                f"{blat['itl_p99_s'] * 1e3:.2f} ms; handed off "
                f"{st['handoffs']}; greedy equal to {base_label} "
                f"{sum(info['greedy_equal_5d'])}/{len(greedy)} "
                f"{card_line()}")
            log(f"{label} sentry: {ticks} evaluated ticks in the window, "
                f"mean {info['sentry']['tick_ms_mean']} ms a tick; "
                f"incidents by rule {fired}; router rules fire iff p99 > "
                f"ceiling: {iff} (ceilings {ceilings}) {card_line()}")
            log(f"{label} spans (host ms, count): "
                + ", ".join(f"{k} {v[0]:.1f} ms / {v[1]}"
                            for k, v in sorted(spans.items()))
                + f"; breaker trips {br.trips}; longest healthy op "
                f"{longest * 1e3:.1f} ms (poll {longest_poll * 1e3:.1f} ms)"
                f" {card_line()}")
            log(f"{label} launches: {launches} {card_line()}")
            door.stop()
            del door, fab, br, tr
            empty_cache(torch, dev)
            # the hang leg
            door, fab, br, tr = stack()
            t_leg = time.perf_counter()
            hres, tripped_s, handed = hang_check(
                fab, br, tr, "r0", budget, cl.retarget(door),
                reqs("h", n_hang), after=4)
            hlat, hst = fab.latency_stats(), fab.stats()
            leg_s = time.perf_counter() - t_leg
    finally:
        door.stop()

    def handed_off(i):
        p = np.asarray(prompts[i])
        return any(np.array_equal(run, p[:len(run)]) for run in handed)
    cold = [i for i in greedy if i < n_hang
            and len(prompts[i]) >= FABRIC_THRESHOLD and not handed_off(i)]
    cold_want = dict(zip(cold, serial_streams(
        model, [prompts[i] for i in cold], SERVE_NEW, **kw)))
    hang_eq = {i: hres[i].get("tokens") == cold_want.get(i, want[i])
               for i in greedy if i < n_hang}
    hclient = client_latency(hres)
    info["hang"] = {"requests": n_hang, "failed": failed(hres),
                    "budget_s": budget, "tripped_s": tripped_s,
                    "trips": br.trips, "handed_off_before_and_after":
                    len(handed), "readmitted": hst["readmitted"],
                    "handoff_failures": hst["handoff_failures"],
                    "cold": cold, "greedy_equal": hang_eq,
                    "cold_first_diff_from_5d": {
                        i: first_diff(hres[i].get("tokens"), want[i])
                        for i in cold},
                    "client": hclient, "router": hlat, "leg_s": leg_s}
    log(f"{label} hang leg ({n_hang} requests; r0, the prefill replica, "
        f"hung after its 4th handoff): longest healthy op of the window "
        f"{longest * 1e3:.1f} ms (poll {longest_poll * 1e3:.1f} ms) -> op "
        f"budget {budget * 1e3:.1f} ms; tripped after {tripped_s:.3f} s, "
        f"trips {br.trips}; handed off {len(handed)}, re-admitted "
        f"{hst['readmitted']}, handoff failures {hst['handoff_failures']}, "
        f"served cold {cold}; greedy equal "
        f"{sum(hang_eq.values())}/{len(hang_eq)} (cold ones against one "
        f"engine serving them cold; the first token where each differs "
        f"from {base_label}'s, None if none: "
        f"{info['hang']['cold_first_diff_from_5d']}); failed "
        f"{len(info['hang']['failed'])}; client {hclient['tokens_per_s']:.1f}"
        f" tokens/s, TTFT p99 {hclient['ttft_p99_s'] * 1e3:.1f} ms; router "
        f"TTFT p99 {hlat['ttft_p99_s'] * 1e3:.1f} ms; {leg_s:.1f} s "
        f"{card_line()}")
    RESULTS[label] = info
    del door, fab, br, tr
    empty_cache(torch, dev)
    missing = [k for k in kernels if launches.get(k, 0) <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the {label} path: "
                         f"{missing}")
    if (info["failed"] or info["warm_failed"]
            or not all(info["greedy_equal_5d"]) or info["trips"]
            or missing_spans or not all(iff.values())):
        raise SystemExit(f"{label}: failed, unequal, tripped, spans "
                         f"missing {missing_spans} or the sentry disagreed "
                         f"with the router; {info}")
    h = info["hang"]
    if (h["failed"] or h["trips"] != 1 or tripped_s >= 2 * budget
            or h["readmitted"] + h["handoff_failures"] < 1
            or not all(hang_eq.values())):
        raise SystemExit(f"{label} hang leg failed: {h}")
    return launches


def decode_step_probe(torch, dev, model, label):
    """After phase 5's or 5b's counted run: the launches of one call of
    each paged entry point (a PROMPT_LENS[0]-token prefill, a decode
    step of B = 8 rows at context CTX_START, a verify of 8 rows of
    SPEC_K + 1 tokens, a CHUNK-token prefill chunk), and that decode step
    timed (device span, host enqueue) and profiled, kept in
    RESULTS[label]."""
    from paddle_tpu_torch.ops.kernels import _build
    core = model.model
    B = SERVE_KW["max_batch"]
    pools, tables = core.alloc_paged_caches(B, SERVE_KW["max_len"],
                                            SERVE_KW["page_size"])
    per = {}
    with torch.inference_mode():
        _build.reset_launches()
        ids = torch.zeros((1, PROMPT_LENS[0]), dtype=torch.int64, device=dev)
        core.prefill_paged(ids, pools, tables[:1])
        per["prefill"] = dict(_build.LAUNCHES)
        _build.reset_launches()
        tok = torch.zeros((B,), dtype=torch.int64, device=dev)
        pos = torch.full((B,), CTX_START - 1, dtype=torch.int64, device=dev)

        def step():
            h, _ = core.decode_step_paged(tok, pos, pools, tables)
            return model.logits(h[:, 0])
        step()
        per["decode_step"] = dict(_build.LAUNCHES)
        _build.reset_launches()
        core.decode_verify_paged(torch.zeros((B, SPEC_K + 1),
                                             dtype=torch.int64, device=dev),
                                 pos, pools, tables)
        per["verify"] = dict(_build.LAUNCHES)
        _build.reset_launches()
        core.prefill_chunk_paged(torch.zeros((1, CHUNK), dtype=torch.int64,
                                             device=dev), CHUNK, pools,
                                 tables[:1])
        per["chunk"] = dict(_build.LAUNCHES)
        host, dev_ms = [], []
        for _ in range(10):
            sync(torch, dev)
            h0 = time.perf_counter()
            span = DeviceSpan(torch, dev)
            step()
            host.append((time.perf_counter() - h0) * 1e3)
            dev_ms.append(span.end())
        prof = profile_step(torch, dev, step, sums=NORM_ROPE_KERNELS)
    weight_bytes = sum(p.numel() * p.element_size()
                       for n, p in model.named_parameters()
                       if n != "model.embed_tokens")
    step_info = {"host_enqueue_ms": statistics.median(host),
                 "device_span_ms": statistics.median(dev_ms),
                 "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S
                 * 1e3, "profile": prof}
    log(f"{label}: launches per call {per}; one decode step at B={B} ctx "
        f"{CTX_START}: {step_info}")
    if prof is not None:
        log(f"{label}: RMSNorm and RoPE in the profiled decode step: "
            + ", ".join(f"{k} {v['us']:.1f} us in {v['launches']} launches"
                        for k, v in prof["sums"].items()))
    RESULTS[label].update(launches_per_call=per, decode_step=step_info)
    del pools
    empty_cache(torch, dev)


def ctx_attention_profile(torch, dev, model, kind):
    """The context attention's device ms in one tick at the feature runs'
    shapes, from torch.profiler: ``kind`` "chunk" is a prefill chunk
    (b = 1, CHUNK tokens at position CTX_START), "verify" a speculative
    verify (b = 8, SPEC_K + 1 tokens a row from CTX_START); each profiled
    as the model call plus its logits, and the attention alone
    (``_paged_ctx_attention`` of every layer on the same inputs). None on
    the CPU."""
    core, cfg = model.model, model.cfg
    B = SERVE_KW["max_batch"]
    pools, tables = core.alloc_paged_caches(B, SERVE_KW["max_len"],
                                            SERVE_KW["page_size"])
    b, C = (1, CHUNK) if kind == "chunk" else (B, SPEC_K + 1)
    tb = tables[:b]
    with torch.inference_mode():
        ids = torch.zeros((b, C), dtype=torch.int64, device=dev)
        if kind == "chunk":
            positions = (torch.arange(C, device=dev) + CTX_START).expand(b, C)

            def tick():
                h, _ = core.prefill_chunk_paged(ids, CTX_START, pools, tb)
                return model.logits(h[0, -1])
        else:
            pos = torch.full((b,), CTX_START, dtype=torch.int64, device=dev)
            positions = pos[:, None] + torch.arange(C, device=dev)

            def tick():
                h, _ = core.decode_verify_paged(ids, pos, pools, tb)
                return model.logits(h)
        q = torch.randn((b, C, cfg.num_attention_heads, cfg.head_dim),
                        device=dev).to(model.model.embed_tokens.dtype)

        def attention():
            for layer, kv in zip(core.layers, pools):
                layer.self_attn._paged_ctx_attention(q, positions, kv, tb)
        tick()
        attention()
        pt_, pa = (profile_step(torch, dev, tick),
                   profile_step(torch, dev, attention))
    del pools
    empty_cache(torch, dev)
    if pt_ is None or pa is None:
        return None
    return {"kind": kind, "rows": b, "tokens_a_row": C, "position": CTX_START,
            "tick_device_busy_ms": pt_["device_busy_ms"],
            "tick_idle_share": pt_["device_idle_share"],
            "ctx_attention_device_ms": pa["device_busy_ms"],
            "ctx_attention_share": pa["device_busy_ms"]
            / pt_["device_busy_ms"]}


GEN_TRAFFIC = dict(rows=8, prompt=512, new=64, page=128, seed=12)


def generation_launches_expected(cfg, int8: bool) -> dict:
    """The launches of one ``generate_paged`` call of GEN_TRAFFIC: a
    prefill and new - 1 decode steps, each pass 2 L + 1 RMSNorms and L
    RoPEs, each decode step L paged decodes, and on an int8 model 4 L +
    1 int8 products a pass (the prefill's 4 L projections on the wgmma
    route, its head at m = rows and every decode step's on the decode
    route)."""
    n, L = GEN_TRAFFIC["new"], cfg.num_hidden_layers
    want = {"rms_norm": n * (2 * L + 1), "fused_rope": n * L,
            ("paged_decode_int8" if int8 else "paged_decode"): (n - 1) * L}
    if int8:
        want.update(int8_matmul=n * (4 * L + 1), int8_matmul_wgmma=4 * L,
                    int8_matmul_decode=1 + (n - 1) * (4 * L + 1))
    return want


def generation_run(torch, dev, model, label):
    """Phase 5f (module docstring) over ``model``; returns the launches
    of its three timed calls together."""
    from paddle_tpu_torch.inference import generation as gen
    from paddle_tpu_torch.ops.kernels import _build
    T, cfg = GEN_TRAFFIC, model.cfg
    core = model.model
    ids = torch.as_tensor(np.random.RandomState(T["seed"]).randint(
        0, cfg.vocab_size, (T["rows"], T["prompt"])), device=dev)
    g = gen.GenerationConfig(max_new_tokens=T["new"])
    calls = {"generate": lambda: gen.generate(model, ids, g),
             "generate_scan": lambda: gen.generate_scan(model, ids, g),
             "generate_paged": lambda: gen.generate_paged(
                 model, ids, g, page_size=T["page"])}
    spans = []

    def spanned(prefill):
        """``prefill`` with a DeviceSpan around it (no sync)."""
        def run(*args, **kw):
            span = DeviceSpan(torch, dev)
            out = prefill(*args, **kw)
            spans.append(span.stop())
            return out
        return run
    info, toks, total = {"calls": {}}, {}, {}
    for name, fn in calls.items():
        kind = "paged" if name == "generate_paged" else "dense"
        fn()
        sync(torch, dev)
        _build.reset_launches()
        spans.clear()
        core.prefill = spanned(core.prefill)
        core.prefill_paged = spanned(core.prefill_paged)
        try:
            t0 = time.perf_counter()
            out = fn()
            sync(torch, dev)
            wall = time.perf_counter() - t0
        finally:
            del core.prefill, core.prefill_paged
        launches = dict(_build.LAUNCHES)
        pre_s = spans[0].ms() / 1e3
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        toks[name] = out[:, T["prompt"]:].cpu().numpy()
        rate = T["rows"] * T["new"] / wall
        info["calls"][name] = {"wall_s": wall, "tokens_per_s": rate,
                               "prefill_s": pre_s, "launches": launches}
        log(f"{label} {name}: {T['rows']} x ({T['prompt']} + {T['new']}) "
            f"tokens in {wall:.3f} s = {rate:.1f} tokens/s; prefill "
            f"({kind} caches, device span in the timed call) "
            f"{pre_s * 1e3:.1f} ms {card_line()}")
    int8 = cfg.weight_dtype == "int8"
    want = generation_launches_expected(cfg, int8)
    got = info["calls"]["generate_paged"]["launches"]
    info["launches_expected"] = want
    info["dense_paged_agreement"] = float(np.mean(
        toks["generate_scan"] == toks["generate_paged"]))
    info["generate_equals_scan"] = bool(np.array_equal(
        toks["generate"], toks["generate_scan"]))
    prof = profile_step(torch, dev, calls["generate_scan"])
    info["generate_scan_profile"] = prof
    log(f"{label}: generate equals generate_scan "
        f"{info['generate_equals_scan']}; dense vs paged token agreement "
        f"{info['dense_paged_agreement']:.4f} (reported only); "
        f"generate_paged launches "
        f"{ {k: got.get(k, 0) for k in want} } (expected {want}); "
        f"generate_scan "
        + (f"device busy {prof['device_busy_ms']:.1f} ms of "
           f"{prof['wall_ms_under_profiler']:.1f} ms under the profiler "
           f"(device activity only), idle share "
           f"{prof['device_idle_share']:.4f}"
           if prof else "profile: no device time reported")
        + f" {card_line()}")
    RESULTS[label] = info
    mark("5f " + label)
    empty_cache(torch, dev)
    if not info["generate_equals_scan"]:
        raise SystemExit(f"{label}: generate and generate_scan differ")
    wrong = {k: (got.get(k, 0), v) for k, v in want.items()
             if got.get(k, 0) != v}
    if wrong:
        raise SystemExit(f"{label}: generate_paged launches (got, "
                         f"expected): {wrong}")
    return total


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return f"[{RESULTS.get('card', 'no card')}]"


def profile_ctx(torch, dev, model, label):
    prof = {kind: ctx_attention_profile(torch, dev, model, kind)
            for kind in ("chunk", "verify")}
    RESULTS[label + "_ctx_attention"] = prof
    for kind, p in prof.items():
        if p is None:
            log(f"{label} context attention ({kind}): no device time "
                f"reported")
            continue
        log(f"{label} context attention in one {kind} tick ({p['rows']} x "
            f"{p['tokens_a_row']} tokens at position {p['position']}): "
            f"{p['ctx_attention_device_ms']:.3f} ms of "
            f"{p['tick_device_busy_ms']:.3f} ms device busy (share "
            f"{p['ctx_attention_share']:.4f}, tick idle share "
            f"{p['tick_idle_share']:.4f}) {card_line()}")


def phase_serving(torch, pt, dev, make_cfg):
    """Phase 5, the serving run of the seeded bf16 model at Llama-3-8B
    widths (all 32 layers, built on the card), then phase 5b: the same
    model quantized on the card (``quantize_model(model,
    kv_dtype="int8")``, the native model then freed) through the same
    run; phase 5c between and after them (the feature runs over the
    native and the quantized model). Returns the launch counts of both
    runs and {label: launches} of the feature runs."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_model
    cfg = make_cfg(dtype="bfloat16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(8, dev))
    sync(torch, dev)
    log(f"serving model: llama3_8b widths, {cfg.num_hidden_layers} layers, "
        f"bf16, built in {time.perf_counter() - t0:.1f} s")
    native, native_streams = serve_run(torch, dev, model, "serving",
                                       SERVING_KERNELS)
    decode_step_probe(torch, dev, model, "serving")
    mark("5 serving")
    decode_census(torch, dev, model)
    mark("17(b) decode census")
    cross = crossover_sweep(torch, dev, model, "serving")
    mark("3c crossover, native")
    features = {label: serve_run(torch, dev, model, label, kernels, feats,
                                 traffic)[0]["launches"]
                for label, feats, traffic, kernels in FEATURE_RUNS}
    mark("5c features, native")
    features["fabric"] = fabric_run(torch, dev, model, "fabric",
                                    SERVING_KERNELS, "serving")
    mark("5d fabric, native")
    features["frontdoor"] = frontdoor_run(torch, dev, model, "frontdoor",
                                          SERVING_KERNELS, "fabric")
    mark("5e front door")
    critical_path_leg(torch, dev, model)
    mark("17(c) critical path")
    features["generation"] = generation_run(torch, dev, model, "generation")
    profile_ctx(torch, dev, model, "serving_features")
    t0 = time.perf_counter()
    qmodel = quantize_model(model, kv_dtype="int8")
    del model
    empty_cache(torch, dev)
    sync(torch, dev)
    log(f"quantized serving model: quantize_model(kv_dtype='int8') on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    quant, quant_streams = serve_run(torch, dev, qmodel,
                                     "quantized_serving",
                                     QUANT_SERVING_KERNELS)
    decode_step_probe(torch, dev, qmodel, "quantized_serving")
    mark("5b quantized serving")
    qcross = crossover_sweep(torch, dev, qmodel, "quantized_serving")
    mark("3c crossover, int8")
    RESULTS["crossover"] = {"native": cross, "int8": qcross}
    features["fabric_int8"] = fabric_run(torch, dev, qmodel, "fabric_int8",
                                         QUANT_SERVING_KERNELS,
                                         "quantized_serving", n_req=8)
    mark("5d fabric, int8")
    features["generation_int8"] = generation_run(torch, dev, qmodel,
                                                 "generation_int8")
    # greedy requests only (every 4th samples): the share of positions
    # where the quantized stream equals the native one (reported only:
    # random weights have near-ties)
    greedy = [i for i in range(len(native_streams)) if i % 4 != 3]
    agree = float(np.mean([np.mean(np.equal(native_streams[i],
                                            quant_streams[i]))
                           for i in greedy]))
    quant["greedy_agreement_with_native"] = agree
    # every int8 product of a prefill (m = the prompt's tokens) must take
    # the wgmma route, and the counted run's prefills with it
    pre = quant["launches_per_call"]["prefill"]
    run = quant["launches"]
    log(f"quantized serving int8 routes: per prefill of 128 tokens "
        f"{pre['int8_matmul_wgmma']} of {pre['int8_matmul']} on wgmma; in "
        f"the run wgmma {run['int8_matmul_wgmma']}, decode "
        f"{run['int8_matmul_decode']}, fp32 {run['int8_matmul_fp32']}")
    if not (0 < pre["int8_matmul"] == pre["int8_matmul_wgmma"]
            and run["int8_matmul_wgmma"] > 0):
        raise SystemExit("int8 prefill products did not take the wgmma "
                         "route")
    log(f"quantized vs native serving: {quant['tokens_per_s']:.1f} vs "
        f"{native['tokens_per_s']:.1f} tokens/s; TTFT p50 "
        f"{quant['latency']['ttft_p50_s'] * 1e3:.1f} vs "
        f"{native['latency']['ttft_p50_s'] * 1e3:.1f} ms; ITL p50 "
        f"{quant['latency']['itl_p50_s'] * 1e3:.2f} vs "
        f"{native['latency']['itl_p50_s'] * 1e3:.2f} ms; model bytes "
        f"{quant['model_bytes']} vs {native['model_bytes']}; KV-pool bytes "
        f"{quant['kv_pool_bytes']} vs {native['kv_pool_bytes']}; greedy "
        f"agreement with the native streams {agree:.3f}")
    label, feats, traffic, kernels = QUANT_FEATURE_RUN
    features[label] = serve_run(torch, dev, qmodel, label, kernels, feats,
                                traffic)[0]["launches"]
    profile_ctx(torch, dev, qmodel, label)
    mark("5c features, int8")
    del qmodel
    empty_cache(torch, dev)
    return native["launches"], quant["launches"], features


def kernel_category(name: str) -> str:
    """A profiler kernel name → the layer it belongs to, for the training
    step's breakdown."""
    if "flash_" in name:
        return "flash " + ("backward" if "bwd" in name else "forward")
    if "vocab_ce" in name:
        return "fused vocab-CE head kernels"
    if "grouped_matmul" in name or "grouped::" in name:
        return "grouped matmul kernels"
    if any(w in name for w in ("Sort", "sort", "topk", "TopK", "scatter",
                               "index_copy", "indexSelect", "index_select",
                               "index_add", "indexFunc")):
        return "MoE routing (sort, top-k, counts, gathers)"
    if "rms_norm" in name or "rope_" in name:
        return "rms_norm / rope kernels"
    if name.startswith(("nvjet", "sm90_", "cutlass")) or "gemm" in name:
        return "GEMM (cuBLAS)"
    if "SoftMax" in name:
        return "log_softmax (loss head)"
    if "embedding" in name or "index" in name:
        return "embedding / index"
    return "elementwise and reductions (optimizer, clip, casts, MLP)"


def log_step_profile(label, prof):
    """Sum a profiled step's kernels by kernel_category() into
    ``prof["by_category"]`` and print the step's busy and idle time."""
    if prof is None:
        log(f"{label} step profile: no device time reported")
        return
    by = {}
    for row in prof["top"]:
        key = kernel_category(row["name"])
        ms, n = by.get(key, (0.0, 0))
        by[key] = (ms + row["ms"], n + row["count"])
    prof["by_category"] = by
    log(f"{label} step profile: device busy {prof['device_busy_ms']:.1f} ms "
        f"of {prof['wall_ms_under_profiler']:.1f} ms (idle share "
        f"{prof['device_idle_share']:.4f}), {prof['launches']} launches; by "
        f"category (ms, launches): {by}")


def train_batch(torch, vocab, b, s, dev, seed, split=None):
    """Token ids, next-token labels and (with ``split``) segment ids
    packing two documents into row 0, the label at the seam ignored."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, s + 1))
    labels = ids[:, 1:].copy()
    batch = {"input_ids": ids[:, :-1], "labels": labels}
    if split is not None:
        seg = np.zeros((b, s), np.int32)
        seg[0, split:] = 1
        labels[0, split - 1] = -100
        batch["segment_ids"] = seg
    return {k: torch.tensor(v, device=dev) for k, v in batch.items()}


# phase 6 in bf16: the card's cuBLAS GEMMs and the CPU's round their
# bf16 outputs differently, so the first step is held per tensor by the
# relative Frobenius error ||card - cpu|| / ||cpu||, which reads
# 8.3e-3 to 1.54e-2 on every tensor (H100 80GB HBM3, 700 W). This is
# the coarse end-to-end check; phase 3's per-row check is the sharp one.
BF16_GRAD_TOL = 3e-2
BF16_LOSS_RTOL = 1e-2


def phase_train_equality(torch, pt, dev, make_cfg, dtype="float32"):
    """Phase 6: the training step on the card (kernels) against the same
    step on the CPU (plain versions). fp32: first-step gradients and 3
    AdamW steps' losses. bf16 (the dtype of the training run, whose
    flash kernels take the Hopper route): the first step's loss and
    gradients."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.trainer import Trainer
    # Llama-3-8B's attention layout; MLP 14336 -> 1024 and vocabulary
    # 128256 -> 4096 so that the CPU steps through it in seconds; the
    # default (fused) loss head
    cfg = make_cfg(num_hidden_layers=2, dtype=dtype, intermediate_size=1024,
                   vocab_size=4096)
    fp32 = dtype == "float32"
    t0 = time.perf_counter()
    card = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(9, dev))
    cpu = copy.deepcopy(card).to("cpu")
    side = {}
    for name, model in (("card", card), ("cpu", cpu)):
        d = next(model.parameters()).device
        batch = train_batch(torch, cfg.vocab_size, 2, 256, d, 9, split=100)
        loss = model(**batch, return_logits=False)
        loss.backward()
        grads = {n: p.grad.detach().float().cpu() for n, p in
                 model.named_parameters()}
        losses = [float(loss.detach())]
        if fp32:
            model.zero_grad(set_to_none=True)
            trainer = Trainer(model, AdamW(
                learning_rate=1e-4, parameters=model, weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0)))
            losses = [float(trainer.train_step(batch)) for _ in range(3)]
        side[name] = (grads, losses)
    (gc, lc), (gp, lp) = side["card"], side["cpu"]
    if fp32:
        # per tensor: max |card - cpu| over the tensor's largest |cpu|
        grad_err = {n: float((gc[n] - gp[n]).abs().max()
                             / gp[n].abs().max().clamp_min(1e-30))
                    for n in gp}
        measure, grad_tol, loss_rtol = "max|diff|/max|cpu|", 1e-4, 1e-4
    else:
        grad_err = {n: float((gc[n] - gp[n]).norm()
                             / gp[n].norm().clamp_min(1e-30)) for n in gp}
        measure, grad_tol = "||diff||/||cpu||", BF16_GRAD_TOL
        loss_rtol = BF16_LOSS_RTOL
    worst = max(grad_err, key=grad_err.get)
    loss_ok = bool(np.allclose(lc, lp, rtol=loss_rtol, atol=0.0))
    grad_ok = grad_err[worst] <= grad_tol
    log(f"training equality (llama3_8b attention layout, 2 layers, MLP "
        f"1024, vocab 4096, {dtype}, 2 x 256 tokens with segments): losses "
        f"card {lc} cpu {lp} (rtol {loss_rtol}: "
        f"{'ok' if loss_ok else 'FAIL'}); first-step gradients: worst "
        f"{measure} {grad_err[worst]:.2e} at {worst} (tol {grad_tol}: "
        f"{'ok' if grad_ok else 'FAIL'}); {time.perf_counter() - t0:.1f} s")
    RESULTS.setdefault("train_equality", {})[dtype] = {
        "losses_card": lc, "losses_cpu": lp, "grad_err": grad_err,
        "grad_measure": measure}
    del card, cpu
    empty_cache(torch, dev)
    if not (loss_ok and grad_ok):
        raise SystemExit(f"{dtype} training on the card differs from the "
                         f"plain path")
    return gc


def phase_recompute_equality(torch, pt, dev, make_cfg, ref):
    """Phase 6, recompute: the fp32 first-step gradients of the phase-6
    model and batch on the card with recompute="full" and "selective",
    against those of the recompute="none" run (``ref``): within 1e-6 of
    each tensor's largest value, and whether they are equal bit for
    bit."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    out = {}
    for rc in ("full", "selective"):
        cfg = make_cfg(num_hidden_layers=2, dtype="float32",
                       intermediate_size=1024, vocab_size=4096, recompute=rc)
        model = LlamaForCausalLM(cfg, device=dev,
                                 generator=pt.generator(9, dev))
        batch = train_batch(torch, cfg.vocab_size, 2, 256, dev, 9, split=100)
        model(**batch, return_logits=False).backward()
        grads = {n: p.grad.detach().float().cpu() for n, p in
                 model.named_parameters()}
        err = {n: float((grads[n] - ref[n]).abs().max()
                        / ref[n].abs().max().clamp_min(1e-30)) for n in ref}
        worst = max(err, key=err.get)
        equal = all(torch.equal(grads[n], ref[n]) for n in ref)
        out[rc] = {"worst": worst, "err": err[worst], "bit_equal": equal,
                   "ok": err[worst] <= 1e-6}
        log(f"recompute={rc!r} (fp32, phase-6 model): first-step gradients "
            f"vs recompute='none': worst max|diff|/max|none| "
            f"{err[worst]:.2e} at {worst} (tol 1e-6: "
            f"{'ok' if out[rc]['ok'] else 'FAIL'}); equal bit for bit: "
            f"{equal}")
        del model
        empty_cache(torch, dev)
    RESULTS["recompute_equality"] = out
    if not all(v["ok"] for v in out.values()):
        raise SystemExit("gradients under recompute differ from those "
                         "without it")


def train_run(torch, pt, dev, cfg, batch, warm_steps, steps, profile=False,
              model_cls=None, cost_leg=False, census_leg=False):
    """Build ``model_cls(cfg)`` (LlamaForCausalLM by default) and its
    trainer (AdamW(1e-4, weight_decay=0.01), global-norm clip 1.0, seed
    10) on ``dev``, take ``warm_steps`` and then ``steps`` timed steps of
    ``batch`` through Trainer.fit, with the launch counts reset just
    before the timed steps and read just after. ``cost_leg``: then the
    cost gauges of the timed steps (:func:`cost_gauges`); ``census_leg``:
    then 17(b), one more step under the census
    (:func:`full_width_census`). Returns the run's numbers."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.trainer import Trainer
    t0 = time.perf_counter()
    model = (model_cls or LlamaForCausalLM)(cfg, device=dev,
                                            generator=pt.generator(10, dev))
    trainer = Trainer(model, AdamW(learning_rate=1e-4, parameters=model,
                                   weight_decay=0.01,
                                   grad_clip=ClipGradByGlobalNorm(1.0)))
    sync(torch, dev)
    built_s = time.perf_counter() - t0
    warm = trainer.fit(iter([batch] * warm_steps), warm_steps, log_every=1)
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    ds0 = dict(trainer.dispatch_stats)
    hist = trainer.fit(iter([batch] * steps), steps, log_every=1)
    sync(torch, dev)
    launches = dict(_build.LAUNCHES)
    host_s = ((trainer.dispatch_stats["dispatch_host_s"]
               - ds0["dispatch_host_s"]) / max(len(hist), 1))
    peak_mem = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None)
    # the step's peak falls in the optimizer update (fp32 temporaries of
    # the largest parameters), where no activation is alive; one more
    # forward and backward alone (a 1F1B pipeline's fused step, as the
    # Trainer takes it) shows the activations' footprint
    fwd_bwd_peak = None
    if dev.type == "cuda":
        model.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats(dev)
        if getattr(model, "pp_schedule", None) == "1f1b":
            model.loss_and_grads(**batch)
        else:
            model(**batch, return_logits=False).backward()
        sync(torch, dev)
        fwd_bwd_peak = torch.cuda.max_memory_allocated(dev)
        model.zero_grad(set_to_none=True)
    b, s = batch["input_ids"].shape
    times = [m.step_time_s for m in hist]
    tps = len(hist) * b * s / sum(times)
    fpt = model.flops_per_token(s)
    info = {"loss_impl": getattr(cfg, "loss_impl", "fused"),
            "recompute": cfg.recompute,
            "layers": cfg.num_hidden_layers, "params": model.num_params(),
            "batch": [b, s], "built_s": built_s,
            "losses": [m.loss for m in warm + hist], "step_times_s": times,
            "median_step_s": statistics.median(times), "tokens_per_s": tps,
            "flops_per_token": fpt,
            "mfu_palm": (tps * fpt / trainer.peak_flops
                         if trainer.peak_flops else None),
            "peak_memory_bytes": peak_mem,
            "fwd_bwd_peak_memory_bytes": fwd_bwd_peak, "launches": launches,
            "launches_per_step": {k: v / len(hist)
                                  for k, v in launches.items()},
            "dispatch_host_s_per_step": host_s,
            "card": trainer.card}
    if profile:
        info["profile_step"] = profile_step(
            torch, dev, lambda: float(trainer.train_step(batch)), top=None)
    if cost_leg:
        info["cost_gauges"] = cost_gauges(torch, dev, trainer, batch, info)
    if census_leg:
        from paddle_tpu_torch.analysis.graphs import trainer_inputs
        full_width_census(torch, dev, "train_8b",
                          lambda: trainer.train_step(batch),
                          lambda: trainer_inputs(trainer), cfg.vocab_size)
    del trainer, model
    empty_cache(torch, dev)
    return info


COST_SUM_RTOL = 1e-9       # the breakdown's buckets against the step


COST_STEPS = 4             # the cost leg's published steps


def cost_gauges(torch, dev, trainer, batch, info):
    """Phase 7's cost leg, after its timed steps (which ran with the
    registry off, as before): with the registry on, one step (the first
    of its shape under the registry: the step census, timed; its window
    publishes nothing), then COST_STEPS steps at log_every=1 whose log
    boundaries publish the gauges (``Trainer._emit``). Reads what the
    trainer published after the last of them: the breakdown against that
    step's measured time, the census MFU beside the same step's PaLM MFU
    and phase 7's, their ratio, and the drift verdict the planner reads
    (``check_drift``). Fails unless the breakdown sums to the step within
    COST_SUM_RTOL, the census window published nothing, and the drift
    lies inside the planner's band."""
    from paddle_tpu_torch.distributed.auto_parallel import planner
    from paddle_tpu_torch.observability import REGISTRY

    def rows():
        return {(r["name"], r["labels"].get("bucket")): r["value"]
                for r in REGISTRY.collect()
                if r["labels"].get("component") == "train"
                and "value" in r and r["name"].startswith("pt_")}

    REGISTRY.reset()
    REGISTRY.enable()
    try:
        t0 = time.perf_counter()
        trainer.fit(iter([batch]), 1, log_every=1)
        sync(torch, dev)
        census_s = time.perf_counter() - t0
        after_census = rows()
        hist = trainer.fit(iter([batch] * COST_STEPS), COST_STEPS,
                           log_every=1)
        sync(torch, dev)
        got = rows()
        drift = planner.check_drift()
    finally:
        REGISTRY.reset()
        REGISTRY.disable()
    watch = trainer._cost_watch
    buckets = {b: v for (n, b), v in got.items()
               if n == "pt_step_time_breakdown"}
    mfu = got[("pt_model_flops_utilization", None)]
    step_s = hist[-1].step_time_s
    total = sum(buckets.values())
    census_published = sorted({n for (n, _) in after_census
                               if n != "pt_cost_census_seconds_total"})
    out = {"breakdown": buckets, "step_s": step_s,
           "step_times_s": [m.step_time_s for m in hist],
           "sum_rel_err": abs(total - step_s) / step_s,
           "mfu_gauge": mfu, "mfu_palm_step": hist[-1].mfu,
           "mfu_ratio": mfu / hist[-1].mfu,
           "mfu_palm_phase7": info["mfu_palm"],
           "hbm_bw_utilization": got[("pt_hbm_bw_utilization", None)],
           "predicted_over_measured": got[
               ("pt_step_time_predicted_over_measured", None)],
           "drift": {"status": drift["status"], "ratios": drift["ratios"],
                     "band": list(planner.DRIFT_BAND)},
           "census_flops": watch.report.total_flops,
           "census_bytes": watch.report.total_bytes,
           "census_step_s": census_s, "census_s": watch.census_s,
           "census_window_published": census_published}
    out["ok"] = (len(buckets) == 5 and not census_published
                 and out["sum_rel_err"] <= COST_SUM_RTOL
                 and drift["status"] == "ok")
    log(f"training cost gauges (published by the trainer at the last of "
        f"{COST_STEPS} steps, step {step_s:.4f} s; phase 7's median "
        f"{info['median_step_s']:.4f} s): breakdown {buckets} (sum off by "
        f"{out['sum_rel_err']:.3g} relative); census MFU {mfu:.4f} against "
        f"the same step's PaLM MFU {hist[-1].mfu:.4f} (ratio "
        f"{out['mfu_ratio']:.4f}; phase 7's PaLM MFU {info['mfu_palm']}); "
        f"bandwidth {out['hbm_bw_utilization']:.4f}; predicted/measured "
        f"{out['predicted_over_measured']:.4f}, check_drift "
        f"{drift['status']!r}; the census step {census_s:.2f} s, its "
        f"window published {census_published or 'nothing'} "
        f"{card_line()}")
    return out


def phase_train(torch, pt, dev, make_cfg, b=2, s=4096):
    """Phase 7: train 4 layers at Llama-3-8B widths on the card (batch
    b x s tokens) in the default configuration (fused vocab-CE head, no
    recompute): 2 warm-up and 8 timed steps, every training kernel
    counted. Then, on the same batch, 2 + 4 steps each of the naive head
    and of recompute "full" and "selective", for their step time and
    peak memory; the default run's peak must lie below the naive
    head's."""
    cfg = make_cfg(num_hidden_layers=4, dtype="bfloat16")
    batch = train_batch(torch, cfg.vocab_size, b, s, dev, 10)
    info = train_run(torch, pt, dev, cfg, batch, 2, 8, profile=True,
                     cost_leg=True, census_leg=True)
    launches, losses = info["launches"], info["losses"]
    RESULTS["training"] = info
    log(f"training model: llama3_8b widths, {cfg.num_hidden_layers} layers, "
        f"bf16, default head ({cfg.loss_impl}), {info['params'] / 1e9:.3f} "
        f"B parameters, built in {info['built_s']:.1f} s; card "
        f"{info['card']}")
    log(f"training: 8 timed steps of {b} x {s} tokens: "
        f"{info['tokens_per_s']:.1f} tokens/s, median step "
        f"{info['median_step_s']:.4f} s, MFU (PaLM, vs "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16, {info['card']}) "
        f"{info['mfu_palm']}, peak memory {info['peak_memory_bytes']} "
        f"bytes (forward + backward alone "
        f"{info['fwd_bwd_peak_memory_bytes']})")
    log(f"training losses: {losses}")
    log(f"training launches per step: {info['launches_per_step']}")
    log_step_profile("training", info["profile_step"])
    variants = {}
    for name, kw in (("naive_head", dict(loss_impl="naive")),
                     ("recompute_full", dict(recompute="full")),
                     ("recompute_selective", dict(recompute="selective"))):
        v = train_run(torch, pt, dev, make_cfg(num_hidden_layers=4,
                                               dtype="bfloat16", **kw),
                      batch, 2, 4)
        variants[name] = v
        log(f"training variant {name}: 4 timed steps: "
            f"{v['tokens_per_s']:.1f} tokens/s, median step "
            f"{v['median_step_s']:.4f} s, MFU {v['mfu_palm']}, peak memory "
            f"{v['peak_memory_bytes']} bytes (forward + backward alone "
            f"{v['fwd_bwd_peak_memory_bytes']}), losses {v['losses']}")
    RESULTS["training_variants"] = variants
    missing = [k for k in TRAINING_KERNELS if launches[k] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the training path: "
                         f"{missing}")
    if not info["cost_gauges"]["ok"]:
        raise SystemExit(f"the cost gauges failed: {info['cost_gauges']}")
    if launches["vocab_ce_fwd_wgmma"] != launches["vocab_ce_fwd"]:
        raise SystemExit(f"CE forward launches off the wgmma route: "
                         f"{launches['vocab_ce_fwd_wgmma']} of "
                         f"{launches['vocab_ce_fwd']}")
    for name, run in [("default", info)] + list(variants.items()):
        if not all(math.isfinite(x) for x in run["losses"]):
            raise SystemExit(f"training loss not finite ({name}): "
                             f"{run['losses']}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"training loss did not fall: {losses}")
    naive_peak = variants["naive_head"]["peak_memory_bytes"]
    if dev.type == "cuda" and not info["peak_memory_bytes"] < naive_peak:
        raise SystemExit(f"the fused head's peak memory "
                         f"{info['peak_memory_bytes']} is not below the "
                         f"naive head's {naive_peak}")
    return launches


# -- MoE: the grouped matmul kernels, equality and the training run -------

def expert_counts(torch, kind, m, e, g):
    """int32 group sizes summing to m over e experts: "balanced" (equal),
    or "skewed": a quarter of the experts empty and the rest drawn from a
    Zipf law (exponent 1.2) in random order."""
    if kind == "balanced":
        return torch.full((e,), m // e, dtype=torch.int32, device="cuda")
    live = e - e // 4
    w = 1.0 / torch.arange(1, live + 1, dtype=torch.float64) ** 1.2
    c = torch.floor(w / w.sum() * m).long()
    c[0] += m - int(c.sum())
    c = torch.cat([c, torch.zeros(e - live, dtype=torch.long)])
    perm = torch.randperm(e, generator=g, device="cuda").cpu()
    return c[perm].to(torch.int32).cuda()


def grouped_library(torch, case, a, b, ends, gs):
    """The yardstick for one grouped product: ``torch._grouped_mm`` (bf16
    out; cumulative ``offs``) where this torch has it and it takes these
    operands, else a loop of torch.matmul over a host-side split (timed
    only; the port calls neither). ``case``: "fwd" a [m, k] · b [g, k, n],
    "dw" a [m, k]^T · b [m, n] per run. Returns (callable, name)."""
    runs = [int(c) for c in gs.tolist()]
    if case == "fwd":
        def loop():
            return [torch.matmul(x, b[i]) for i, x in
                    enumerate(torch.split(a, runs)) if runs[i]]
    else:
        def loop():
            return [torch.matmul(x.t(), y) for x, y in
                    zip(torch.split(a, runs), torch.split(b, runs))]
    fn = getattr(torch, "_grouped_mm", None)
    if fn is not None:
        args = (a, b) if case == "fwd" else (a.t(), b)
        try:
            fn(*args, offs=ends)
            torch.cuda.synchronize()
            return (lambda: fn(*args, offs=ends)), "torch._grouped_mm"
        except (RuntimeError, TypeError, ValueError) as e:
            RESULTS.setdefault("grouped_mm_refused", []).append(
                f"{case}: {str(e)[:200]}")
    return loop, "torch.matmul loop over a host split"


MOE_M, MOE_E = 49152, 64      # 2 x 4096 tokens x top-6; 64 experts


def phase_moe_kernels(torch, pt):
    """Phase 3, the grouped matmul at the bf16 dropless DeepSeekMoE-16B
    step's shapes (m = 49152 rows, 64 experts): the forward at gate_up
    (k 2048, n 2816) and down (k 1408, n 2048), with balanced and skewed
    counts, dx (the forward kernel reading the weight transposed) and dW
    of each, against the plain versions, elementwise and per row, timed
    beside the plain loop and the library call; a planted wrong
    tile→group (every run's offsets taken from the run before it) and a
    planted dW row shift (every run one row later) must fail the row
    check. fp32 at a small ragged shape (an empty group, a group
    smaller than a tile, rows past the groups)."""
    from paddle_tpu_torch.ops import grouped_matmul as gmm
    from paddle_tpu_torch.ops.kernels import grouped_matmul as kgm
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1357)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    planted = {}
    bf = torch.bfloat16

    def plant(kernel, case, what, got, want):
        e = flash_compare(torch, [(got, want)], "bfloat16")
        planted[f"{kernel}/{case}/{what}"] = {
            "row_err": e[3], "row_caught": not e[5], "max_abs_err": e[0]}
        log(f"planted fault in {kernel} [{case}] ({what}): max_abs_err="
            f"{e[0]:.3e}, row_err={e[3]:.3e} vs row_tol {ROW_TOL} (row check "
            f"{'rejects' if not e[5] else 'MISSES'} it)")
        if e[5]:
            FAILED_CASES.append(f"{kernel}/{case}/{what}_missed")

    for proj, (k, n) in (("gate_up", (2048, 2816)), ("down", (1408, 2048))):
        w = (0.02 * torch.randn((MOE_E, k, n), generator=g,
                                device=dev)).to(bf)
        xs = torch.randn((MOE_M, k), generator=g, device=dev).to(bf)
        gy = torch.randn((MOE_M, n), generator=g, device=dev).to(bf)
        for kind in ("balanced", "skewed"):
            case = f"{proj}_{kind}"
            gs = expert_counts(torch, kind, MOE_M, MOE_E, g)
            ends = kgm.group_ends(gs)
            live = int((gs > 0).sum())
            ops = 2 * MOE_M * k * n
            wbytes = live * k * n * 2
            lib_f, lib_name = grouped_library(torch, "fwd", xs, w, ends, gs)
            lib_dx, _ = grouped_library(torch, "fwd", gy, w.transpose(1, 2),
                                        ends, gs)
            lib_dw, lib_dw_name = grouped_library(torch, "dw", xs, gy, ends,
                                                  gs)
            RESULTS.setdefault("grouped_library", {})[case] = [lib_name,
                                                               lib_dw_name]
            y = kgm.grouped_matmul(xs, w, ends)
            want = gmm.grouped_matmul_plain(xs, w, gs)
            t = (timed_ms(torch, lambda: kgm.grouped_matmul(xs, w, ends),
                          flush),
                 timed_ms(torch, lambda: gmm.grouped_matmul_plain(
                     xs, w, gs), flush, reps=10),
                 timed_ms(torch, lib_f, flush))
            bnd = bound(MOE_M * k * 2 + wbytes + MOE_M * n * 4, ops,
                        BF16_OPS_PER_S)
            record("grouped_matmul", case, "bfloat16",
                   flash_compare(torch, [(y, want)], "bfloat16"), *t, bnd)
            product_rate("grouped_matmul", case, ops, bnd, t[0], t[2],
                    key="gemm_rates")
            # every run's rows taken from the run before: rows multiply
            # the next expert's weight, the last run's rows become 0
            shifted = torch.cat([ends.new_zeros(1), ends[:-1]])
            plant("grouped_matmul", case, "tile_group_shifted",
                  kgm.grouped_matmul(xs, w, shifted), want)
            del y, want
            dx = kgm.grouped_matmul(gy, w, ends, out_dtype=bf,
                                    transpose_w=True)
            want = gmm.grouped_matmul_plain(gy, w.transpose(1, 2),
                                            gs).to(bf)
            t = (timed_ms(torch, lambda: kgm.grouped_matmul(
                     gy, w, ends, out_dtype=bf, transpose_w=True), flush),
                 timed_ms(torch, lambda: gmm.grouped_matmul_plain(
                     gy, w.transpose(1, 2), gs).to(bf), flush, reps=10),
                 timed_ms(torch, lib_dx, flush))
            bnd = bound(MOE_M * n * 2 + wbytes + MOE_M * k * 2, ops,
                        BF16_OPS_PER_S)
            record("grouped_matmul", f"{proj}_dx_{kind}", "bfloat16",
                   flash_compare(torch, [(dx, want)], "bfloat16"), *t, bnd)
            product_rate("grouped_matmul", f"{proj}_dx_{kind}", ops, bnd, t[0],
                    t[2], key="gemm_rates")
            del dx, want
            dw = kgm.grouped_matmul_dw(xs, gy, ends, out_dtype=bf)
            want = gmm.grouped_matmul_dw_plain(xs, gy, gs).to(bf)
            t = (timed_ms(torch, lambda: kgm.grouped_matmul_dw(
                     xs, gy, ends, out_dtype=bf), flush),
                 timed_ms(torch, lambda: gmm.grouped_matmul_dw_plain(
                     xs, gy, gs).to(bf), flush, reps=10),
                 timed_ms(torch, lib_dw, flush))
            bnd = bound(MOE_M * (k + n) * 2 + MOE_E * k * n * 2, ops,
                        BF16_OPS_PER_S)
            record("grouped_matmul_dw", case, "bfloat16",
                   flash_compare(torch, [(dw, want)], "bfloat16"), *t, bnd)
            product_rate("grouped_matmul_dw", case, ops, bnd, t[0], t[2],
                    key="gemm_rates")
            again = kgm.grouped_matmul_dw(xs, gy, ends, out_dtype=bf)
            if not torch.equal(again, dw):
                FAILED_CASES.append(f"grouped_matmul_dw/{case}/"
                                    f"not_bit_identical")
            del again
            empty = gs == 0
            if bool(empty.any()) and int(torch.count_nonzero(dw[empty])):
                FAILED_CASES.append(f"grouped_matmul_dw/{case}/empty_not_0")
            # every run one row later: each run's dW loses its first row
            # and gains the next run's first
            plant("grouped_matmul_dw", case, "row_shift",
                  kgm.grouped_matmul_dw(xs, gy, (ends + 1).clamp_max(MOE_M),
                                        out_dtype=bf), want)
            del dw, want
            torch.cuda.synchronize()
        del w, xs, gy
        torch.cuda.empty_cache()

    # fp32: FMAs, ragged everything, rows past the groups
    counts = torch.tensor([37, 0, 5, 300, 1], dtype=torch.int32, device=dev)
    m, k, n = 400, 96, 80
    xs = torch.randn((m, k), generator=g, device=dev)
    w = 0.1 * torch.randn((5, k, n), generator=g, device=dev)
    gy = torch.randn((m, n), generator=g, device=dev)
    ends = kgm.group_ends(counts)
    for kernel, got, want in (
            ("grouped_matmul", kgm.grouped_matmul(xs, w, ends),
             gmm.grouped_matmul_plain(xs, w, counts)),
            ("grouped_matmul", kgm.grouped_matmul(gy, w, ends,
                                                  transpose_w=True),
             gmm.grouped_matmul_plain(gy, w.transpose(1, 2), counts))):
        record(kernel, "ragged_400", "float32",
               compare(torch, got, want, "float32"))
    # dW sums up to 300 rows in another order: the rounding error scales
    # with the summands, not with the (often cancelling) result, so it is
    # held to 1e-5 of its largest magnitude, as the RMSNorm backward's dw
    dw = kgm.grouped_matmul_dw(xs, gy, ends)
    want = gmm.grouped_matmul_dw_plain(xs, gy, counts)
    diff, scale = float((dw - want).abs().max()), float(want.abs().max())
    record("grouped_matmul_dw", "ragged_400", "float32",
           (diff, diff / scale, diff <= 1e-5 * scale), tol="1e-5 of max")
    RESULTS["planted_moe"] = planted
    del flush
    torch.cuda.empty_cache()


def phase_parent_turns(torch, parent):
    """With ``--parent DIR`` (the parent commit's tree unpacked in DIR):
    the parent's kernels against this tree's on the same inputs, each
    library built from its own tree's sources, timed in turns (parent,
    this, this, parent) as timed_ms times phase 3's rows: the int8
    product at the five decode projections (m = 8) and at gate_up
    (n 28672, k 4096) with m = 128 and 1024, and the grouped forward, dx
    and dW at phase 3's DeepSeekMoE-16B shapes, balanced and skewed,
    through this tree's wrappers (their C interface is unchanged;
    with_library); then paged decode and the CE kernels
    (parent_serving_and_ce_turns), the bf16 flash backward at phase 3's
    training shape, and the RMSNorm forward and RoPE
    (parent_norm_rope_turns). The two results' largest difference is kept
    beside the times."""
    from pathlib import Path
    from paddle_tpu_torch.nn.quantized_linear import weight_quantize
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import grouped_matmul as kgm
    from paddle_tpu_torch.ops.kernels import int8_matmul as kmm
    root = Path(parent).resolve()
    build_log = {}
    plib = _build.load(_build.build(root / "paddle_tpu_torch" / "csrc",
                                    root / "build" / "torch_kernels",
                                    build_log))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(97)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    bf = torch.bfloat16
    rows = {}

    def turns(name, parent_fn, this_fn, exact=False, reps=25):
        """exact: the two trees' outputs must be equal bit for bit."""
        diff = float((parent_fn().float() - this_fn().float()).abs().max())
        t = [timed_ms(torch, f, flush, reps=reps)
             for f in (parent_fn, this_fn, this_fn, parent_fn)]
        rows[name] = {"parent_us": [t[0] * 1e3, t[3] * 1e3],
                      "this_us": [t[1] * 1e3, t[2] * 1e3],
                      "max_abs_diff": diff}
        log(f"parent vs this tree, {name}: parent {t[0] * 1e3:.1f} us, this "
            f"{t[1] * 1e3:.1f} us, this {t[2] * 1e3:.1f} us, parent "
            f"{t[3] * 1e3:.1f} us; max |parent - this| {diff:.3e}")
        if exact and diff != 0.0:
            FAILED_CASES.append(f"parent_turns/{name}_not_bit_equal")

    # the int8 product's C interface is the parent's too (the decode
    # route's workspace, tickets and split are in both trees): both run
    # through this tree's wrapper, the parent's with its library in place
    for case, m, (n, k) in (
            *((f"decode_{p}", 8, nk) for p, nk in DECODE_PROJECTIONS.items()),
            ("prefill_gate_up_128", 128, (28672, 4096)),
            ("prefill_gate_up_1024", 1024, (28672, 4096))):
        wq, scale = weight_quantize(0.02 * torch.randn((k, n), generator=g,
                                                       device=dev))
        x = torch.randn((m, k), generator=g, device=dev).to(bf)

        def this_mm(x=x, wq=wq, scale=scale):
            return kmm.int8_matmul(x, wq, scale)
        turns(f"int8_matmul/{case}", with_library(plib, this_mm), this_mm)
        del wq, scale, x
    torch.cuda.empty_cache()
    for proj, (k, n) in (("gate_up", (2048, 2816)), ("down", (1408, 2048))):
        w = (0.02 * torch.randn((MOE_E, k, n), generator=g,
                                device=dev)).to(bf)
        xs = torch.randn((MOE_M, k), generator=g, device=dev).to(bf)
        gy = torch.randn((MOE_M, n), generator=g, device=dev).to(bf)
        for kind in ("balanced", "skewed"):
            ends = kgm.group_ends(expert_counts(torch, kind, MOE_M, MOE_E,
                                                g))
            for name, fn in (
                    (f"grouped_matmul/{proj}_{kind}",
                     lambda: kgm.grouped_matmul(xs, w, ends)),
                    (f"grouped_matmul/{proj}_dx_{kind}",
                     lambda: kgm.grouped_matmul(gy, w, ends, out_dtype=bf,
                                                transpose_w=True)),
                    (f"grouped_matmul_dw/{proj}_{kind}",
                     lambda: kgm.grouped_matmul_dw(xs, gy, ends,
                                                   out_dtype=bf))):
                turns(name, with_library(plib, fn), fn)
        del w, xs, gy
        torch.cuda.empty_cache()
    # the bf16 flash backward at phase 3's training shape, through this
    # tree's wrapper (the C interface is the parent's; its kernel adds dq
    # into the front of this tree's larger workspace in its own layout,
    # so the turns compare dk)
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    q, dout = (torch.randn((2, 4096, 32, 128), generator=g,
                           device=dev).to(bf) for _ in range(2))
    k, v = (torch.randn((2, 4096, 8, 128), generator=g, device=dev).to(bf)
            for _ in range(2))
    out, lse = kfa.flash_fwd(q, k, v, True, 128 ** -0.5)
    delta = (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()

    def this_bwd():
        return kfa.flash_bwd(q, k, v, dout, lse, delta, True, 128 ** -0.5)[1]
    turns("flash_bwd/train_4096", with_library(plib, this_bwd), this_bwd)
    del q, k, v, dout, out, lse, delta
    torch.cuda.empty_cache()
    parent_serving_and_ce_turns(torch, plib, dev, g, flush, turns)
    parent_norm_rope_turns(torch, plib, dev, g, turns)
    RESULTS["parent_turns"] = {"parent": str(root), "rows": rows,
                               "parent_build_s": build_log.get("seconds")}
    del flush
    torch.cuda.empty_cache()


def parent_norm_rope_turns(torch, plib, dev, g, turns):
    """The parent's RMSNorm forward and RoPE kernels against this tree's
    at phase 3's shapes (decode, prefill and training at Llama's widths
    and training at DeepSeekMoE's), bf16, both through this tree's
    wrappers (the parent has this tree's C interface and plans;
    with_library). The decode rows are also profiled as a decode step
    runs them: 65 (RMSNorm) or 32 (RoPE) launches back to back, no L2
    flush, device time from torch.profiler."""
    from paddle_tpu_torch.ops import rope as rope_ops
    from paddle_tpu_torch.ops.kernels import fused_norm, fused_rope
    profiled = {}

    def profiled_turns(name, parent_fn, this_fn, n):
        """Device us a launch, as torch.profiler reports it, of n launches
        back to back (a decode step's count), parent / this / this /
        parent."""
        per = []
        for fn in (parent_fn, this_fn, this_fn, parent_fn):
            prof = profile_step(torch, dev, lambda fn=fn: [
                fn() for _ in range(n)], sums={"all": ("",)})
            # None: the profiler reported no device time for this window
            per.append(prof and prof["sums"]["all"]["us"] / n)
        profiled[name] = {"launches": n, "parent_us": [per[0], per[3]],
                          "this_us": [per[1], per[2]]}
        log(f"profiled, {n} launches back to back, {name}: device us a "
            f"launch: parent {per[0]}, this {per[1]}, this {per[2]}, "
            f"parent {per[3]}")
    for case, R, width in NORM_CASES:
        x = torch.randn((R, width), generator=g, device=dev).to(
            torch.bfloat16)
        w = 1 + 0.1 * torch.randn((width,), generator=g, device=dev)

        def this_norm(x=x, w=w):
            return fused_norm.rms_norm_fwd(x, w, 1e-5)[0]
        par_norm = with_library(plib, this_norm)
        turns(f"rms_norm/{case}", par_norm, this_norm)
        if case == "decode_b8":
            profiled_turns(f"rms_norm/{case}", par_norm, this_norm, 65)
    cos, sin = rope_ops.rope_freqs(128, 8192, 500000.0, device=dev)
    for case, (b, s), (h, hkv) in ROPE_CASES:
        qkv = torch.randn((b, s, (h + 2 * hkv) * 128), generator=g,
                          device=dev).to(torch.bfloat16)
        q = qkv[..., :h * 128].view(b, s, h, 128)
        k = qkv[..., h * 128:(h + hkv) * 128].view(b, s, hkv, 128)
        pos = rope_positions(torch, g, dev, case, b, s)

        def this_rope(q=q, k=k, pos=pos):
            return fused_rope.fused_rope(q, k, cos, sin, pos)[0]
        par_rope = with_library(plib, this_rope)
        # the difference is read on the rotated q (k takes the same path)
        turns(f"fused_rope/{case}", par_rope, this_rope)
        if case == "decode_b8":
            profiled_turns(f"fused_rope/{case}", par_rope, this_rope, 32)
    RESULTS["norm_rope_profiled_decode"] = profiled


def with_library(lib, fn):
    """``fn`` as a call that runs with the kernel library ``lib`` (another
    tree's, of the same C interface) in place of this tree's, so that this
    tree's wrappers launch that tree's kernels."""
    from paddle_tpu_torch.ops.kernels import _build

    def call():
        own, _build._LIB = _build._LIB, lib
        try:
            return fn()
        finally:
            _build._LIB = own
    return call


def parent_serving_and_ce_turns(torch, plib, dev, g, flush, turns):
    """The parent's and this tree's paged decode (native and int8 pools,
    phase 3's ctx1024 shape, bf16) and CE forward (phase 3's train_8192
    shape) in turns, and the CE backward's dlog, dh and dW of one chunk,
    which must be equal bit for bit. These kernels' C interfaces are the
    parent's too, so the parent's run through this tree's wrappers with
    the parent's library in place (``with_library``)."""
    from paddle_tpu_torch.ops.kernels import fused_vocab_ce as kce
    from paddle_tpu_torch.ops.kernels import paged_attention
    on = with_library
    bf = torch.bfloat16
    B, H, HKV, HD, page, ctx = 8, 32, 8, 128, 128, 1024
    mp = 2048 // page
    num_pages = B * mp + 1
    q = torch.randn((B, H, HD), generator=g, device=dev).to(bf)
    tables = (torch.randperm(num_pages - 1, generator=g, device=dev)
              [:B * mp] + 1).view(B, mp).to(torch.int32).contiguous()
    lens = torch.full((B,), ctx - 1, dtype=torch.int64, device=dev)
    native = tuple(torch.randn((HKV, num_pages, page, HD), generator=g,
                               device=dev).to(bf) for _ in range(2))
    quant = (quant_pages(torch, g, dev, HKV, num_pages, page, HD),
             quant_pages(torch, g, dev, HKV, num_pages, page, HD))
    for name, kp, vp, sc in (
            ("paged_decode/ctx1024", *native, {}),
            ("paged_decode_int8/ctx1024", quant[0][0], quant[1][0],
             dict(k_scales=quant[0][1], v_scales=quant[1][1]))):
        def this(kp=kp, vp=vp, sc=sc):
            return paged_attention.paged_decode(q, kp, vp, tables, lens,
                                                **sc)
        turns(name, on(plib, this), this)
    del native, quant, q
    torch.cuda.empty_cache()

    N, Hd, V, C = 8192, 4096, 128256, kce.CHUNK
    h = torch.randn((N, Hd), generator=g, device=dev).to(bf)
    w = (0.02 * torch.randn((Hd, V), generator=g, device=dev)).to(bf)
    labels = torch.randint(0, V, (N,), generator=g, device=dev).to(
        torch.int32)
    labels[::97] = -1

    def fwd():
        return torch.stack(kce.vocab_ce_fwd(h, w, labels))
    turns("vocab_ce_fwd/train_8192", on(plib, fwd), fwd, reps=10)
    lse = fwd()[0].contiguous()
    g_lse = torch.randn((N,), generator=g, device=dev)
    g_tgt = torch.randn((N,), generator=g, device=dev)
    dl_p, dl_t = (torch.empty((N, C), dtype=bf, device=dev)
                  for _ in range(2))
    turns("vocab_ce_dlog/train_chunk_8192",
          on(plib, lambda: kce.vocab_ce_dlog(h, w, labels, lse, g_lse, g_tgt,
                                             0, C, dl_p)),
          lambda: kce.vocab_ce_dlog(h, w, labels, lse, g_lse, g_tgt, 0, C,
                                    dl_t), exact=True)
    dh_p, dh_t = torch.empty_like(h), torch.empty_like(h)
    turns("vocab_ce_dh/train_chunk_8192",
          on(plib, lambda: kce.vocab_ce_dh(dl_t, w, 0, C, dh_p)),
          lambda: kce.vocab_ce_dh(dl_t, w, 0, C, dh_t), exact=True)
    del dh_p, dh_t
    dw_p, dw_t = torch.empty_like(w), torch.empty_like(w)
    turns("vocab_ce_dw/train_chunk_8192",
          on(plib, lambda: kce.vocab_ce_dw(h, dl_t, 0, C, dw_p)[:, :C]),
          lambda: kce.vocab_ce_dw(h, dl_t, 0, C, dw_t)[:, :C], exact=True)
    del dw_p, dw_t, dl_p, dl_t, h, w
    torch.cuda.empty_cache()


def norm_rope_gaps():
    """The RMSNorm and RoPE forwards at their launched shapes (phase 3's
    bf16 rows): time, bound, the launch floor, launches a call of the
    path that runs that shape (a decode step and a prefill of phase 5, a
    step of phase 7 or 9) and launches x the gap to the least time, in
    us. The least time of a decode row is max(bound, floor): its bytes
    take nanoseconds, and no launch takes less than the floor."""
    floor = RESULTS["launch_floor_us"]
    calls = RESULTS["serving"]["launches_per_call"]
    per = {"decode_b8": calls["decode_step"],
           "prefill_1024": calls["prefill"],
           "verify_b8x5": calls["verify"], "chunk_512": calls["chunk"],
           "train": RESULTS["training"]["launches_per_step"],
           "train_moe": RESULTS["moe_training"]["launches_per_step"]}
    rows = {}
    for c in RESULTS["kernel_cases"]:
        if (c["kernel"] not in ("rms_norm", "fused_rope")
                or c["dtype"] != "bfloat16" or c["ms"] is None):
            continue
        case = c["case"]
        path = ("train_moe" if case.endswith("_moe") else
                "train" if case.startswith("train") else case)
        n = per[path][c["kernel"]]
        bound_us = c["bound_ms"] * 1e3
        least = (max(bound_us, floor) if case in ("decode_b8", "verify_b8x5")
                 else bound_us)
        row = {"us": c["ms"] * 1e3, "bound_us": bound_us, "floor_us": floor,
               "copy_us": c["copy_ms"] * 1e3, "least_us": least,
               "share_of_least": least / (c["ms"] * 1e3),
               "launches": n,
               "launches_x_gap_us": n * (c["ms"] * 1e3 - least)}
        rows[f"{c['kernel']}/{case}"] = row
        log(f"{c['kernel']} [{case}]: {row['us']:.2f} us, bound "
            f"{bound_us:.2f} us, floor {floor:.2f} us, a copy of its bytes "
            f"{row['copy_us']:.2f} us, least "
            f"{least:.2f} us ({row['share_of_least']:.2f} of it), {n} "
            f"launches a call, launches x gap "
            f"{row['launches_x_gap_us']:.1f} us")
    RESULTS["norm_rope_gaps"] = rows


def phase_moe_sync(torch, pt, dev):
    """Phase 8, host syncs: one dropless MoELayer at DeepSeekMoE-16B
    widths (hidden 2048, 64 experts of 1408, top-6, bf16) over 4096
    tokens, forward and backward under
    torch.cuda.set_sync_debug_mode("error") after a warm-up pass: any
    call that makes the host wait for the device raises."""
    from paddle_tpu_torch.parallel.moe import MoELayer
    layer = MoELayer(2048, 1408, 64, top_k=6, capacity_factor=None,
                     dtype="bfloat16", device=dev,
                     generator=pt.generator(11, dev))
    x = torch.randn((1, 4096, 2048), device=dev, dtype=torch.bfloat16,
                    generator=pt.generator(12, dev), requires_grad=True)

    def step():
        out, aux = layer(x)
        (out.float().square().mean() + aux).backward()
    step()
    sync(torch, dev)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    sync(torch, dev)
    RESULTS["moe_sync_check"] = "no host sync in one MoELayer fwd + bwd"
    log("MoE host-sync check: one dropless MoELayer forward + backward "
        "(DeepSeekMoE-16B widths, 4096 tokens, bf16) ran under "
        "set_sync_debug_mode('error')")
    del layer, x
    empty_cache(torch, dev)


def routing_ids(torch, model):
    """Forward pre-hooks on every MoE layer that keep the top-k expert
    ids each token is routed to, sorted (the order of the choices does
    not matter to the result): returns (ids list, hook handles)."""
    ids, handles = [], []
    for layer in model.layers:
        moe = getattr(layer, "moe", None)
        if moe is None:
            continue

        def hook(mod, args):
            with torch.no_grad():
                z = args[0].reshape(-1, args[0].shape[-1])
                probs = torch.softmax(mod._logits(z), dim=-1)
                ids.append(torch.topk(probs, mod.top_k, dim=-1)[1].sort(
                    -1)[0].cpu())
        handles.append(moe.register_forward_pre_hook(hook))
    return ids, handles


# phase 8 in bf16: the card's and the CPU's bf16 rounding differ, and a
# token whose k-th and (k+1)-th router probabilities are near-equal can
# then take another expert; the loss is held to BF16_LOSS_RTOL and the
# differing routing ids are reported
def phase_moe_equality(torch, pt, dev, make_cfg, dtype):
    """Phase 8: DeepSeekMoE-16B's attention and expert layout (hidden
    2048, 16 heads, 64 experts of 1408, top-6, 2 shared experts) at 2
    layers (1 dense, 1 MoE) with the dense MLP cut to 1024 and the
    vocabulary to 4096, dropless, the same seeded weights and batch
    (2 x 256 tokens) on the card (kernels) and on the CPU (plain
    versions): routing ids, the first step's loss and gradients. fp32:
    no routing id may differ, loss rtol 1e-4, gradients 1e-4 of each
    tensor's largest; bf16: loss rtol BF16_LOSS_RTOL, gradients and
    differing ids reported."""
    from paddle_tpu_torch.models import MoEForCausalLM
    cfg = make_cfg(num_hidden_layers=2, intermediate_size=1024,
                   vocab_size=4096, capacity_factor=None, dtype=dtype)
    t0 = time.perf_counter()
    card = MoEForCausalLM(cfg, device=dev, generator=pt.generator(9, dev))
    cpu = copy.deepcopy(card).to("cpu")
    side = {}
    for name, model in (("card", card), ("cpu", cpu)):
        d = next(model.parameters()).device
        batch = train_batch(torch, cfg.vocab_size, 2, 256, d, 9)
        ids, handles = routing_ids(torch, model)
        loss = model(**batch, return_logits=False)
        for h in handles:
            h.remove()
        loss.backward()
        side[name] = (float(loss.detach()), torch.cat(ids),
                      {n: p.grad.detach().float().cpu()
                       for n, p in model.named_parameters()})
    (lc, ic, gc), (lp, ip, gp) = side["card"], side["cpu"]
    differ = int((ic != ip).any(-1).sum())
    grad_err = {n: float((gc[n] - gp[n]).abs().max()
                         / gp[n].abs().max().clamp_min(1e-30)) for n in gp}
    worst = max(grad_err, key=grad_err.get)
    fp32 = dtype == "float32"
    loss_rtol = 1e-4 if fp32 else BF16_LOSS_RTOL
    loss_ok = abs(lc - lp) <= loss_rtol * abs(lp)
    ok = loss_ok and (not fp32 or (differ == 0 and grad_err[worst] <= 1e-4))
    log(f"MoE equality (deepseek_moe_16b widths, 2 layers, MLP 1024, vocab "
        f"4096, dropless, {dtype}, 2 x 256 tokens): loss card {lc} cpu {lp} "
        f"(rtol {loss_rtol}); tokens whose routing ids differ: {differ} of "
        f"{ip.shape[0]}; first-step gradients: worst max|diff|/max|cpu| "
        f"{grad_err[worst]:.2e} at {worst}"
        f"{' (tol 1e-4)' if fp32 else ' (reported)'}: "
        f"{'ok' if ok else 'FAIL'}; {time.perf_counter() - t0:.1f} s")
    RESULTS.setdefault("moe_equality", {})[dtype] = {
        "loss_card": lc, "loss_cpu": lp, "routing_tokens_differ": differ,
        "tokens": ip.shape[0], "grad_err": grad_err}
    del card, cpu
    empty_cache(torch, dev)
    if not ok:
        raise SystemExit(f"{dtype} MoE training on the card differs from "
                         f"the plain path")


MOE_TRAINING_KERNELS = TRAINING_KERNELS + ("grouped_matmul",
                                           "grouped_matmul_dw")


def phase_moe_train(torch, pt, dev, make_cfg, b=2, s=4096):
    """Phase 9: train DeepSeekMoE-16B widths at 4 layers (1 dense + 3
    MoE), bf16, dropless, fused vocab-CE head, AdamW(1e-4, weight_decay
    0.01), clip 1.0, batch b x s from a numpy seed: 2 warm-up and 8 timed
    steps through Trainer.fit, launch counts reset just before and read
    just after, one step profiled. Then 2 + 4 steps at capacity_factor
    1.25 on the same batch. Every training kernel and both grouped-matmul
    kernels must launch, and the loss must be finite and fall."""
    from paddle_tpu_torch.models import MoEForCausalLM
    cfg = make_cfg(num_hidden_layers=4, capacity_factor=None,
                   dtype="bfloat16")
    batch = train_batch(torch, cfg.vocab_size, b, s, dev, 10)
    info = train_run(torch, pt, dev, cfg, batch, 2, 8, profile=True,
                     model_cls=MoEForCausalLM)
    launches, losses = info["launches"], info["losses"]
    RESULTS["moe_training"] = info
    log(f"MoE training model: deepseek_moe_16b widths, "
        f"{cfg.num_hidden_layers} layers, bf16, dropless, "
        f"{info['params'] / 1e9:.3f} B parameters, built in "
        f"{info['built_s']:.1f} s; card {info['card']}")
    log(f"MoE training: 8 timed steps of {b} x {s} tokens: "
        f"{info['tokens_per_s']:.1f} tokens/s, median step "
        f"{info['median_step_s']:.4f} s, MFU (activated parameters, vs "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16, {info['card']}) "
        f"{info['mfu_palm']}, peak memory {info['peak_memory_bytes']} bytes "
        f"(forward + backward alone {info['fwd_bwd_peak_memory_bytes']})")
    log(f"MoE training losses: {losses}")
    log(f"MoE training launches per step: {info['launches_per_step']}")
    log_step_profile("MoE training", info["profile_step"])
    cap = train_run(torch, pt, dev, make_cfg(
        num_hidden_layers=4, capacity_factor=1.25, dtype="bfloat16"),
        batch, 2, 4, model_cls=MoEForCausalLM)
    RESULTS["moe_training_capacity"] = cap
    log(f"MoE training at capacity_factor 1.25: 4 timed steps: "
        f"{cap['tokens_per_s']:.1f} tokens/s, median step "
        f"{cap['median_step_s']:.4f} s, MFU {cap['mfu_palm']}, peak memory "
        f"{cap['peak_memory_bytes']} bytes, losses {cap['losses']}, "
        f"launches per step {cap['launches_per_step']}")
    missing = [k for k in MOE_TRAINING_KERNELS if launches[k] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the MoE training path: "
                         f"{missing}")
    # every grouped launch of the dropless step on the wgmma route
    off = [k for k in ("grouped_matmul", "grouped_matmul_dw",
                       "vocab_ce_fwd")
           if launches[f"{k}_wgmma"] != launches[k]]
    log(f"MoE training grouped routes per step: "
        f"{info['launches_per_step']['grouped_matmul_wgmma']} + "
        f"{info['launches_per_step']['grouped_matmul_dw_wgmma']} on wgmma "
        f"of {info['launches_per_step']['grouped_matmul']} + "
        f"{info['launches_per_step']['grouped_matmul_dw']}")
    if off:
        raise SystemExit(f"grouped or CE forward launches off the wgmma "
                         f"route: {off}")
    for name, run in (("dropless", info), ("capacity", cap)):
        if not all(math.isfinite(x) for x in run["losses"]):
            raise SystemExit(f"MoE training loss not finite ({name}): "
                             f"{run['losses']}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"MoE training loss did not fall: {losses}")
    return launches


# -- phase 10: the trainer runtime -------------------------------------------

# the poisoned batch of phase 10 is cut to this many tokens: its NaN dense
# mask sends attention to sdpa_plain (the JAX dispatch's dense-mask
# route), whose fp32 scores at 4096 tokens would not fit beside the
# pre-step copy of the state that policy "skip" keeps
POISON_TOKENS = 256
# phase 10's kill leg: phase 6's layout in fp32 through the chaos script
KILL_ARGS = ["--preset", "llama3_8b", "--layers", "2", "--mlp", "1024",
             "--vocab", "4096", "--dtype", "float32", "--seq", "256",
             "--batch", "2", "--async-save"]


class RuntimeTokens:
    """A seeded numpy token dataset: item i is one sequence of ``s``
    tokens and its next-token labels."""

    def __init__(self, vocab, n, s, seed=10):
        self.ids = np.random.RandomState(seed).randint(0, vocab, (n, s + 1))

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i, :-1], "labels": self.ids[i, 1:]}


class PoisonOnce:
    """A collate function that poisons the ``at``-th batch it collates,
    once (``chaos.nan_batch`` over an additive attention mask, the
    batch's only float input, on its first POISON_TOKENS tokens); a
    replay after a rollback collates that batch again, clean."""

    def __init__(self, at):
        self.at, self.n = at, 0

    def __call__(self, items):
        from paddle_tpu_torch.io import default_collate_fn
        from paddle_tpu_torch.testing import chaos
        batch = default_collate_fn(items)
        self.n += 1
        if self.n - 1 != self.at:
            return batch
        cut = {k: v[:, :POISON_TOKENS] for k, v in batch.items()}
        mask = np.zeros((len(items), 1, 1, POISON_TOKENS), np.float32)
        return chaos.nan_batch({**cut, "attn_mask": mask},
                               fields=["attn_mask"])


def runtime_loader(dev, tokens, b, poison_at=None):
    from paddle_tpu_torch.io import DataLoader
    return DataLoader(tokens, batch_size=b, drop_last=True,
                      prefetch_to_device=True, device=dev,
                      collate_fn=(PoisonOnce(poison_at)
                                  if poison_at is not None else None))


def runtime_trainer(torch, pt, dev, cfg, seed, **kw):
    """Phase 7's trainer: AdamW(1e-4, weight_decay 0.01), global-norm clip
    1.0, over a model built from ``seed``."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.trainer import Trainer
    model = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(seed,
                                                                     dev))
    return Trainer(model, AdamW(learning_rate=1e-4, parameters=model,
                                weight_decay=0.01,
                                grad_clip=ClipGradByGlobalNorm(1.0)), **kw)


def differing(torch, a, b):
    """Keys of the live state (parameters, masters, slots) in which
    trainers ``a`` and ``b`` differ (any bit)."""
    live = dict(b._live_tensors())
    return [key for key, t in a._live_tensors()
            if not torch.equal(t, live[key].to(t.device))]


def timed_calls(obj, name, box):
    """Wrap ``obj.name`` so each call's seconds append to ``box``."""
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            box.append(time.perf_counter() - t0)
    setattr(obj, name, wrapped)


def losses_of(hist):
    return {m.step: m.loss for m in hist}


def spread_band(ref_a, ref_b):
    """The two uninterrupted runs' losses by step → (spread, band): the
    spread is their largest difference over the steps both have; a loss
    at step i lies within it when it is inside [min - spread, max +
    spread] of the two runs' losses at i."""
    common = sorted(set(ref_a) & set(ref_b))
    spread = max(abs(ref_a[i] - ref_b[i]) for i in common)
    band = {i: (min(ref_a[i], ref_b[i]) - spread,
                max(ref_a[i], ref_b[i]) + spread) for i in common}
    return spread, band


def outside(band, losses):
    return {i: v for i, v in losses.items()
            if i in band and not band[i][0] <= v <= band[i][1]}


def chaos_result(proc, timeout=600):
    out, _ = proc.communicate(timeout=timeout)
    text = out.decode(errors="replace")
    for line in text.splitlines():
        if line.startswith("CHAOS_RESULT "):
            return proc.returncode, json.loads(line[len("CHAOS_RESULT "):])
    return proc.returncode, text[-3000:]


def kill_leg(torch, dev, root, steps=8, kill_at=7):
    """Phase 10 (f): the chaos script on the card in fp32 (phase 6's
    layout): an uninterrupted run (its only save the final one) beside a
    run saving every 3 steps, async, SIGKILLed at ``kill_at`` once its
    save of step 6 is durable (uncommitted); then a fresh process resumes
    the killed run (again only the final save). Returns the leg's
    record."""
    from paddle_tpu_torch import checkpoint as ckpt
    from paddle_tpu_torch.resilience import CheckpointManager
    from paddle_tpu_torch.testing import chaos
    t0 = time.perf_counter()
    ref_dir, run_dir = os.path.join(root, "ref"), os.path.join(root, "run")
    final_only = KILL_ARGS + ["--save-interval", str(10 * steps)]
    ref = chaos.spawn_trainer(ref_dir, steps=steps, extra_args=final_only)
    killed = chaos.spawn_trainer(run_dir, steps=steps, extra_args=KILL_ARGS
                                 + ["--save-interval", "3",
                                    "--hard-exit-at", str(kill_at)])
    rc_ref, res_ref = chaos_result(ref)
    rc_kill, res_kill = chaos_result(killed)
    latest = ckpt.latest_step(run_dir)
    torn_complete = ckpt.is_complete_checkpoint(os.path.join(run_dir,
                                                             "step_6"))
    rc_res, res = chaos_result(chaos.spawn_trainer(run_dir, steps=steps,
                                                   extra_args=final_only))
    quarantined = CheckpointManager(run_dir).quarantined()
    digest = (lambda r: r["digest"] if isinstance(r, dict) else None)
    rec = {"rc_ref": rc_ref, "rc_killed": rc_kill, "rc_resumed": rc_res,
           "latest_step_after_kill": latest,
           "torn_step_complete": torn_complete, "quarantined": quarantined,
           "digest_ref": digest(res_ref), "digest_resumed": digest(res),
           "ref": res_ref, "resumed": res, "killed_output": (
               res_kill if isinstance(res_kill, str) else None),
           "seconds": time.perf_counter() - t0}
    rec["ok"] = (rc_ref == 0 and rc_res == 0 and rc_kill == -9
                 and rec["digest_ref"] is not None
                 and rec["digest_resumed"] == rec["digest_ref"]
                 and res["step"] == steps and latest == 3
                 and not torn_complete
                 and quarantined == ["step_6-uncommitted"])
    return rec


# the layers of phase 10's save-and-resume leg (a) and of its rollback
# and preemption legs (b, c). The machine with the card ends a command
# that has written 45 GiB (48.3 GB) to its disk, deleted files counted,
# and every checkpoint lives in the output directory (ROOT_OUT): (a) keeps
# Llama-3-8B's widths at 1 layer (17.76 GB a save, two saves, 35.5 GB);
# (b, c) take phase 6's layout in fp32 at 1 layer (1.06 GB a save, three
# saves, 3.2 GB); the kill leg (f) keeps phase 6's 2 layers in fp32
# (1.71 GB a save, four saves: the reference's final one, the killed
# run's steps 3 and 6 and the resumed run's final one, 6.8 GB). 45.5 GB
# in all; the phase prints what its own process wrote
SAVE_LAYERS = 1
BC_LAYERS = 1
# the saves of (d)'s timed fit (steps 3-10 after 2 warm-up steps) under
# save_interval_steps=3, (step, async): JAX's cadence, each periodic save
# at the first dispatch boundary at or after a multiple of the interval,
# the final one synchronous (tests/test_torch_trainer_runtime.py holds
# the port's cadence to the JAX trainer's)
SUPERSTEP_SAVES = {1: [(3, True), (6, True), (9, True), (10, False)],
                   4: [(6, True), (10, False)]}


class SaveRecorder:
    """A stand-in checkpoint manager that records the steps a fit saves at,
    (step, async), and writes nothing: (d) reads the superstep's save
    cadence at full width without writing its bytes."""

    def __init__(self, save_interval_steps, async_save=True):
        self.save_interval_steps = save_interval_steps
        self.async_save = async_save
        self.root = ROOT_OUT
        self.calls = []

    def save(self, step, tree, async_save=None, **kw):
        self.calls.append((step, self.async_save if async_save is None
                           else async_save))
        return True


def record_saves(mgr):
    """Record (step, async) of each ``mgr.save`` call in the returned
    list."""
    calls = []
    save = mgr.save

    def recorded(step, tree, **kw):
        a = kw.get("async_save")
        calls.append((step, mgr.async_save if a is None else a))
        return save(step, tree, **kw)
    mgr.save = recorded
    return calls


def rollback_and_preemption(torch, pt, dev, cfg, tokens, root, b=2):
    """Phase 10 (b, rollback) and (c) on ``cfg``: a NaN batch at step 4
    under policy="rollback" with a manager saving every 3 steps, then a
    preemption at step 6 and a fresh trainer resuming it. Returns the two
    records, each with its verdict under "ok"."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.resilience import (AnomalyGuard, CheckpointManager,
                                             PreemptionGuard,
                                             TrainingPreempted)
    r = runtime_trainer(torch, pt, dev, cfg, 9)
    data = runtime_loader(dev, tokens, b, poison_at=3)
    mgr = CheckpointManager(os.path.join(root, "r"), save_interval_steps=3,
                            keep_last_n=1, async_save=True)
    at3, restored = {}, []
    restore = r._apply_restored

    def checked(tree):
        cursor = restore(tree)
        restored.append(all(torch.equal(p, at3[k])
                            for k, p in r.params.items()))
        return cursor
    r._apply_restored = checked
    led = obs.ledger()
    led.reset()
    guard = AnomalyGuard(policy="rollback", warmup_steps=100)
    hist = r.fit(data, 5, log_every=1, checkpoint_manager=mgr,
                 anomaly_guard=guard,
                 on_metrics=lambda m: at3.update(
                     {k: p.detach().clone() for k, p in r.params.items()})
                 if m.step == 3 else None)
    r._apply_restored = restore
    clean = runtime_trainer(torch, pt, dev, cfg, 9)
    clean.fit(runtime_loader(dev, tokens, b), 5, log_every=1)
    rb = {"rollbacks": guard.rollbacks,
          "steps_logged": [m.step for m in hist],
          "restored_equal": restored,
          "cursor": data.state_dict()["batches_served"],
          "rollback_wasted_s": led.totals()["rollback_wasted"],
          "committed": mgr.committed_steps(),
          "differing_from_clean": differing(torch, r, clean)}
    del clean
    rb["ok"] = (guard.rollbacks == 1 and restored == [True]
                and rb["steps_logged"] == [1, 2, 3, 4, 5]
                and rb["cursor"] == 5 and rb["rollback_wasted_s"] > 0
                and rb["committed"] == [5]
                and not rb["differing_from_clean"])
    obs.enable(flight_dir=os.path.join(root, "flight"))
    pg = PreemptionGuard()
    code = None
    data.set_state_dict(data.state_dict())
    try:
        r.fit(data, 3, log_every=1, checkpoint_manager=mgr,
              preemption_guard=pg,
              on_metrics=lambda m: pg.trigger() if m.step >= 6 else None)
    except TrainingPreempted as e:
        code = e.code
    finally:
        preempts = obs.REGISTRY.counter("pt_preemptions_total").value()
        obs.disable()
    flight = os.path.join(mgr.root, "_flight")
    reasons = []
    for name in (os.listdir(flight) if os.path.isdir(flight) else []):
        with open(os.path.join(flight, name)) as f:
            reasons.append(json.load(f)["reason"])
    p = runtime_trainer(torch, pt, dev, cfg, 12)
    data_p = runtime_loader(dev, tokens, b)
    p.fit(data_p, 6, log_every=1, resume="auto",
          checkpoint_manager=CheckpointManager(mgr.root,
                                               save_interval_steps=3))
    pre = {"exit_code": code, "committed": mgr.committed_steps(),
           "flight_dumps": reasons, "preemptions_counted": preempts,
           "resumed_differing": differing(torch, r, p)}
    del r
    went_on = p.fit(data_p, 1, log_every=1)
    pre["went_on"] = [(m.step, m.loss) for m in went_on]
    pre["ok"] = (code == 75 and pre["committed"] == [6]
                 and reasons == ["preemption"] and preempts == 1
                 and not pre["resumed_differing"] and went_on
                 and went_on[0].step == 7
                 and math.isfinite(went_on[0].loss))
    return rb, pre


def phase_trainer_runtime(torch, pt, dev, make_cfg, b=2, s=4096):
    """Phase 10: the trainer runtime (see the module docstring for (a)-(f)
    and the depths). Launch counts are reset before the first leg and
    read after (e); every training kernel must launch. Returns the
    launches."""
    import shutil
    from paddle_tpu_torch import checkpoint as ckpt
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.resilience import (AnomalyGuard, CheckpointManager,
                                             PreemptionGuard,
                                             TrainingPreempted)
    cfg = make_cfg(num_hidden_layers=4, dtype="bfloat16")
    cfg_a = make_cfg(num_hidden_layers=SAVE_LAYERS, dtype="bfloat16")
    small = make_cfg(num_hidden_layers=BC_LAYERS, dtype="float32",
                     intermediate_size=1024, vocab_size=4096)
    card = RESULTS.get("card")
    out = RESULTS.setdefault("trainer_runtime", {"card": card})
    cuda = dev.type == "cuda"
    fails = []
    root = os.path.join(ROOT_OUT, "runtime_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out["disk_free_bytes"] = shutil.disk_usage(root).free
    tokens = RuntimeTokens(cfg.vocab_size, 64 * b, s)
    small_tokens = RuntimeTokens(small.vocab_size, 64, 256)
    gb = 1e9
    saves0 = list(ckpt.writer().saves)
    out["cycles_collected"] = collect_cycles(torch, dev, "phase 10")
    _build.reset_launches()
    try:
        # (b, skip) first: its pre-step copy needs the card to itself
        st = runtime_trainer(torch, pt, dev, cfg, 10, donate=False)
        data_s = runtime_loader(dev, RuntimeTokens(cfg.vocab_size, 4 * b, s),
                                b, poison_at=3)
        pre = {}
        sync(torch, dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        guard = AnomalyGuard(policy="skip", warmup_steps=100)
        st.fit(data_s, 5, log_every=1, anomaly_guard=guard,
               on_metrics=lambda m: pre.update(
                   {k: p.detach().clone() for k, p in st.params.items()})
               if m.step == 3 else None)
        peak_skip = torch.cuda.max_memory_allocated(dev) if cuda else 0
        same = all(torch.equal(p, pre[k]) for k, p in st.params.items())
        skip = {"skips": guard.skips, "step": st._step,
                "cursor": data_s.state_dict()["batches_served"],
                "params_equal_pre_step": same,
                "peak_memory_bytes_donate_false": peak_skip}
        out["skip"] = skip
        log(f"runtime (b) skip: NaN batch at step 4 under policy='skip', "
            f"donate=False: skips {guard.skips}, step {st._step}, cursor "
            f"{skip['cursor']}, parameters equal their pre-step values bit "
            f"for bit: {same}; peak memory {peak_skip} bytes "
            f"({peak_skip / gb:.2f} GB; the pre-step copy of the state); "
            f"{card}")
        if not (guard.skips == 1 and st._step == 3 and skip["cursor"] == 4
                and same):
            fails.append("skip")
        del st, pre
        empty_cache(torch, dev)

        # (a) save and resume, at SAVE_LAYERS layers
        data_a = runtime_loader(dev, tokens, b)
        a = runtime_trainer(torch, pt, dev, cfg_a, 10)
        mgr = CheckpointManager(os.path.join(root, "a"),
                                save_interval_steps=3, keep_last_n=1,
                                async_save=True)
        calls = record_saves(mgr)
        t0 = time.perf_counter()
        hist_a = a.fit(data_a, 6, log_every=1, checkpoint_manager=mgr)
        fit_a_s = time.perf_counter() - t0
        state_bytes = sum(t.numel() * t.element_size()
                          for _, t in a._live_tensors())
        saves = [dict(x) for x in ckpt.writer().saves][-2:]
        committed_a = mgr.committed_steps()
        a.model.zero_grad(set_to_none=True)
        data_b = runtime_loader(dev, tokens, b)
        bt = runtime_trainer(torch, pt, dev, cfg_a, 11)
        mgr_b = CheckpointManager(mgr.root, save_interval_steps=3,
                                  keep_last_n=1, async_save=True)
        verify_s, apply_s = [], []
        timed_calls(mgr_b, "verify", verify_s)
        timed_calls(bt, "_apply_restored", apply_s)
        t0 = time.perf_counter()
        bt.fit(data_b, 6, log_every=1, checkpoint_manager=mgr_b,
               resume="auto")
        sync(torch, dev)
        resume_s = time.perf_counter() - t0
        diff = differing(torch, a, bt)
        sa, sb = (x.optimizer.lr_scheduler for x in (a, bt))
        resumed = {
            "differing": diff, "step": bt._step,
            "opt_step": bt.opt_state["step"],
            "cursor": data_b.state_dict()["batches_served"],
            "cursor_a": data_a.state_dict()["batches_served"],
            "sched_equal": (sa is None and sb is None) or (
                sa.state_dict() == sb.state_dict())}
        out["save_resume"] = {
            "layers": SAVE_LAYERS, "state_bytes": state_bytes,
            "disk_free_bytes": out["disk_free_bytes"], "saves": saves,
            "save_calls": calls, "committed": committed_a,
            "fit_6_steps_s": fit_a_s, "resume_s": resume_s,
            "verify_s": verify_s, "apply_s": apply_s, **resumed}
        log(f"runtime (a) save ({SAVE_LAYERS} layer(s) at Llama-3-8B "
            f"widths, bf16): state {state_bytes} bytes "
            f"({state_bytes / gb:.2f} GB), disk free "
            f"{out['disk_free_bytes']} bytes; saves at {calls} (step, "
            f"async); committed {committed_a}; {card}")
        for x in saves:
            w = x.get("write_s", float("nan"))
            into = "pinned buffers" if x["async"] else "plain host copies"
            log(f"runtime (a) save {os.path.basename(x['path'])}: snapshot "
                f"{x['snapshot_s']:.3f} s (synchronous, into {into}), write "
                f"+ sha256 {w:.3f} s "
                f"({'background' if x['async'] else 'synchronous'}), "
                f"{x.get('bytes', 0) / w / gb:.3f} GB/s; {card}")
        log(f"runtime (a) resume: {resume_s:.3f} s in all (verify "
            f"{sum(verify_s):.3f} s, copy into the live tensors "
            f"{sum(apply_s):.3f} s); differing tensors {len(diff)}; step "
            f"{bt._step}, optimizer step {bt.opt_state['step']}, scheduler "
            f"equal {resumed['sched_equal']}, cursor {resumed['cursor']} "
            f"(the saver's {resumed['cursor_a']}); {card}")
        if (diff or bt._step != 6 or bt.opt_state["step"] != 6
                or not resumed["sched_equal"] or resumed["cursor"] != 6
                or resumed["cursor_a"] != 6 or committed_a != [6]
                or calls != [(3, True), (6, False)]):
            fails.append("save/resume")
        # the resumed trainer's next 2 steps against two uninterrupted
        # runs: the saver going on, and a fresh run of 8 steps
        data_b.set_state_dict(data_b.state_dict())
        run_b = losses_of(bt.fit(data_b, 2, log_every=1))
        del bt
        empty_cache(torch, dev)
        data_a.set_state_dict(data_a.state_dict())
        hist_a += a.fit(data_a, 2, log_every=1)
        run_a = losses_of(hist_a)
        del a
        empty_cache(torch, dev)
        c = runtime_trainer(torch, pt, dev, cfg_a, 10)
        run_c = losses_of(c.fit(runtime_loader(dev, tokens, b), 8,
                                log_every=1))
        del c
        empty_cache(torch, dev)
        spread, band = spread_band(run_a, run_c)
        off_b = outside(band, run_b)
        out["save_resume"].update(next_losses=run_b, spread=spread,
                                  outside_band=off_b)
        log(f"runtime (a) next 2 losses of the resumed trainer {run_b}; two "
            f"uninterrupted runs differ by at most {spread:.3e}; outside "
            f"their band: {off_b}; {card}")
        if off_b:
            fails.append("resumed losses")

        # (b, rollback) and (c) on phase 6's layout in fp32, BC_LAYERS deep
        before = dict(_build.LAUNCHES)
        rb, pre_c = rollback_and_preemption(
            torch, pt, dev, small, small_tokens, os.path.join(root, "bc"))
        fp32_ce = _build.LAUNCHES["vocab_ce_fwd"] - before["vocab_ce_fwd"]
        out["rollback"], out["preemption"] = rb, pre_c
        log(f"runtime (b) rollback (phase 6's layout at {BC_LAYERS} "
            f"layer(s), fp32): NaN batch at "
            f"step 4 under policy='rollback': rollbacks {rb['rollbacks']}, "
            f"restored state equal to step 3's: {rb['restored_equal']}, "
            f"steps logged {rb['steps_logged']}, cursor {rb['cursor']} "
            f"(replayed from 3), rollback_wasted "
            f"{rb['rollback_wasted_s']:.3f} s, committed {rb['committed']}, "
            f"final state equal to an unpoisoned run's: "
            f"{not rb['differing_from_clean']}; {card}")
        log(f"runtime (c) preemption (phase 6's layout at {BC_LAYERS} "
            f"layer(s), fp32): trigger() at "
            f"step 6: exit code {pre_c['exit_code']}, committed "
            f"{pre_c['committed']}, flight dumps {pre_c['flight_dumps']}, "
            f"pt_preemptions_total {pre_c['preemptions_counted']}; a fresh "
            f"trainer resumes it ({len(pre_c['resumed_differing'])} "
            f"differing tensors) and goes on: {pre_c['went_on']}; {card}")
        if not rb["ok"]:
            fails.append("rollback")
        if not pre_c["ok"]:
            fails.append("preemption")

        # (d) the superstep, K = 4 against K = 1 (timed)
        sup, runs = {}, {}
        for K in (1, 4):
            tr = runtime_trainer(torch, pt, dev, cfg, 10)
            it = iter(runtime_loader(dev, tokens, b))
            hist = tr.fit(it, 2, log_every=1, steps_per_dispatch=K)
            reads0 = tr.dispatch_stats["loss_reads"]
            rec = SaveRecorder(3)
            sync(torch, dev)
            t0 = time.perf_counter()
            hist += tr.fit(it, 8, log_every=1, steps_per_dispatch=K,
                           checkpoint_manager=rec)
            sync(torch, dev)
            wall = time.perf_counter() - t0
            reads = tr.dispatch_stats["loss_reads"] - reads0
            prof = profile_step(torch, dev, lambda: tr.fit(
                it, K, log_every=1, steps_per_dispatch=K), top=None)
            runs[f"K={K}"] = losses_of(hist)
            sup[K] = {"step_s": wall / 8, "loss_reads_8_steps": reads,
                      "saves": rec.calls,
                      "dispatch_host_s_per_step":
                          tr.dispatch_stats["dispatch_host_s"]
                          / tr.dispatch_stats["steps"],
                      "idle_share": prof and prof["device_idle_share"],
                      "busy_ms": prof and prof["device_busy_ms"],
                      "wall_ms": prof and prof["wall_ms_under_profiler"],
                      "losses": [m.loss for m in hist]}
            log(f"runtime (d) steps_per_dispatch={K}: step "
                f"{sup[K]['step_s']:.4f} s over 8 steps, host loss reads "
                f"{sup[K]['loss_reads_8_steps']} in 8 steps (log_every=1), "
                f"enqueue {sup[K]['dispatch_host_s_per_step']:.4f} s a step, "
                f"saves at {rec.calls}; one profiled dispatch of {K} "
                f"step(s): device busy {sup[K]['busy_ms']} ms of "
                f"{sup[K]['wall_ms']} ms (idle share "
                f"{sup[K]['idle_share']}); {card}")
            del tr
            empty_cache(torch, dev)
        dev4 = max(abs(runs["K=4"][i] - runs["K=1"][i]) for i in runs["K=1"])
        # the superstep is the same step: K=4 equals K=1 bit for bit,
        # losses and state, in bf16 (the flash backward sums dq in a fixed
        # order) and in fp32, at phase 7's widths and depth, 6 steps each
        # (K=4 dispatches 4 then 2), K=1's state kept on the host while
        # K=4 runs
        gate, ce0 = {}, None
        for dtype in ("bfloat16", "float32"):
            if dtype == "float32":
                ce0 = _build.LAUNCHES["vocab_ce_fwd"]
            cfg_g = make_cfg(num_hidden_layers=4, dtype=dtype)
            losses, t0 = {}, time.perf_counter()
            for K in (1, 4):
                tr = runtime_trainer(torch, pt, dev, cfg_g, 10)
                h = tr.fit(runtime_loader(dev, tokens, b), 6, log_every=1,
                           steps_per_dispatch=K)
                if K == 1:
                    host1 = {key: t.detach().cpu()
                             for key, t in tr._live_tensors()}
                else:
                    differ = [key for key, t in tr._live_tensors()
                              if not torch.equal(t.cpu(), host1[key])]
                losses[K] = [m.loss for m in h]
                del tr, h
                empty_cache(torch, dev)
            del host1
            gate[dtype] = {"bit_equal": not differ
                           and losses[1] == losses[4],
                           "differing": differ, "losses": losses,
                           "seconds": time.perf_counter() - t0}
        fp32_ce += _build.LAUNCHES["vocab_ce_fwd"] - ce0
        cadence_ok = all(sup[K]["saves"] == want
                         for K, want in SUPERSTEP_SAVES.items())
        sup.update(k4_distance=dev4, gate=gate, cadence_ok=cadence_ok,
                   expected_saves=SUPERSTEP_SAVES)
        out["superstep"] = sup
        log(f"runtime (d) losses of the timed runs: K=4 at most {dev4:.3e} "
            f"from K=1; K=4 equal to K=1 bit for bit (losses and state, "
            f"phase 7's widths, 4 layers, 6 steps each): bf16 "
            f"{gate['bfloat16']['bit_equal']} "
            f"({gate['bfloat16']['seconds']:.1f} s for both), fp32 "
            f"{gate['float32']['bit_equal']} "
            f"({gate['float32']['seconds']:.1f} s); saves on dispatch "
            f"boundaries as JAX's: {cadence_ok} ({SUPERSTEP_SAVES}); {card}")
        if not (all(v["bit_equal"] for v in gate.values()) and cadence_ok):
            fails.append("superstep")

        # (e) optimizer-state offload
        x = runtime_trainer(torch, pt, dev, cfg, 10)
        o = runtime_trainer(torch, pt, dev, cfg, 10, offload_opt_state=True)
        batch = next(iter(runtime_loader(dev, tokens, b)))
        x._loss(batch).backward()
        grads = {k: p.grad.detach().clone() for k, p in x.params.items()}
        x.optimizer.apply_gradients(x.params, {k: g.clone() for k, g in
                                               grads.items()}, lr=1e-4)
        o.optimizer.apply_gradients(o.params, grads, lr=1e-4)
        sync(torch, dev)
        same_update = all(torch.equal(p, o.params[k])
                          for k, p in x.params.items())
        on_host = not cuda or all(t.is_pinned() for key, t in
                                  o._live_tensors() if key[0] != "params")
        del x, grads, batch
        empty_cache(torch, dev)
        it = iter(runtime_loader(dev, tokens, b))
        o.fit(it, 2, log_every=1)
        sync(torch, dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        hist_o = o.fit(it, 4, log_every=1)
        sync(torch, dev)
        step_o = (time.perf_counter() - t0) / 4
        peak_o = torch.cuda.max_memory_allocated(dev) if cuda else 0
        off_rec = {"same_update_bit_for_bit": same_update,
                   "state_on_host": on_host, "step_s": step_o,
                   "peak_memory_bytes": peak_o,
                   "losses": [m.loss for m in hist_o]}
        out["offload"] = off_rec
        log(f"runtime (e) offload (masters and moments in pinned host "
            f"memory, streamed a parameter at a time): one update from the "
            f"same gradients equal to the update on the card bit for bit: "
            f"{same_update}; state on the host: {on_host}; peak memory "
            f"{peak_o} bytes ({peak_o / gb:.2f} GB; phase 7 without offload: "
            f"37.19 GB), step {step_o:.4f} s (phase 7: 0.2731 s); {card}")
        if not (same_update and on_host and all(
                math.isfinite(m.loss) for m in hist_o)):
            fails.append("offload")
        del o
        empty_cache(torch, dev)
    finally:
        # the checkpoints (tens of GB) never outlive the phase
        ckpt.writer().release()
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(_build.LAUNCHES)
    out["launches"] = launches
    log(f"runtime launches (a)-(e): {launches}")
    out["checkpoint_bytes_written"] = sum(
        x.get("bytes", 0) for x in ckpt.writer().saves
        if not any(x is y for y in saves0))
    log(f"runtime (a)-(c) checkpoint bytes written: "
        f"{out['checkpoint_bytes_written']}")
    kill_root = os.path.join(ROOT_OUT, "runtime_kill")
    shutil.rmtree(kill_root, ignore_errors=True)
    os.makedirs(kill_root)
    try:
        kill = kill_leg(torch, dev, kill_root)
    finally:
        shutil.rmtree(kill_root, ignore_errors=True)
    out["kill"] = kill
    log(f"runtime (f) kill leg (fp32, phase 6's layout, 8 steps, save every "
        f"3 async, SIGKILL at 7): exit codes ref {kill['rc_ref']}, killed "
        f"{kill['rc_killed']}, resumed {kill['rc_resumed']}; latest_step "
        f"after the kill {kill['latest_step_after_kill']}, quarantined "
        f"{kill['quarantined']}; digests ref {kill['digest_ref']} resumed "
        f"{kill['digest_resumed']}; {kill['seconds']:.1f} s; {card}")
    if not kill["ok"]:
        fails.append("kill")
    if fails:
        raise SystemExit(f"trainer runtime checks failed: {fails}")
    missing = [k for k in TRAINING_KERNELS if launches[k] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched in the trainer runtime: "
                         f"{missing}")
    # bf16 CE forwards take the wgmma route; the fp32 legs' take fma
    if launches["vocab_ce_fwd_wgmma"] != launches["vocab_ce_fwd"] - fp32_ce:
        raise SystemExit(f"trainer runtime: bf16 CE forward launches off "
                         f"the wgmma route: {launches['vocab_ce_fwd_wgmma']} "
                         f"of {launches['vocab_ce_fwd'] - fp32_ce}")
    return launches


# -- phase 11: the remaining optimizers, LBFGS and loss scaling -------------

# (class, arguments beside learning_rate=1e-4 and the global-norm clip):
# the JAX defaults, weight decay 0.01 where the optimizer takes one;
# RMSProp centered (three slots); Rprop master-less by default (D15)
PHASE11_OPTIMIZERS = (
    ("SGD", {"weight_decay": 0.01}),
    ("Momentum", {"weight_decay": 0.01}),
    ("Adamax", {"weight_decay": 0.01}),
    ("Adagrad", {"weight_decay": 0.01}),
    ("RMSProp", {"weight_decay": 0.01, "centered": True}),
    ("Adadelta", {"weight_decay": 0.01}),
    ("Lamb", {"lamb_weight_decay": 0.01}),
    ("Rprop", {}),
)
# (b): the card's update against the CPU's, max |card - cpu| / max |cpu|
# per tensor; both run the same fp32 elementwise formulas (Lamb's norms
# sum in another order). (b) runs without the clip: the global norm sums
# in another order on each side (the clipped gradients 2e-7 apart), and
# where the decay nearly cancels a gradient, Adamax's normalised update
# moves by up to 3.8e-6 of the largest parameter for it (H100 80GB HBM3,
# 700 W), which says nothing of the update's arithmetic
UPDATE_RTOL = 1e-6


def make_optimizer(name, kw, params, clip=True):
    from paddle_tpu_torch import optimizer as topt
    return getattr(topt, name)(
        learning_rate=1e-4, parameters=params,
        grad_clip=topt.ClipGradByGlobalNorm(1.0) if clip else None, **kw)


def worst_rel(torch, got, want):
    """(largest max|got - want| / max|want| over the tensors, its key)."""
    err = {k: float((got[k].float().cpu() - w.float()).abs().max()
                    / w.float().abs().max().clamp_min(1e-30))
           for k, w in want.items()}
    k = max(err, key=err.get)
    return err[k], k


def optimizer_updates(torch, pt, dev, small, card):
    """(b): one phase-6 fp32 model's first-step gradients of two batches,
    taken on the card; each optimizer (without the clip: UPDATE_RTOL)
    applies both on the card and on the CPU from the same fresh state:
    parameters and slots within UPDATE_RTOL. Then the layout cast to bf16
    under Rprop without a master (D15): card and CPU within one bf16
    ulp."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    model = LlamaForCausalLM(small, device=dev, generator=pt.generator(9,
                                                                       dev))
    grads = []
    for seed in (9, 19):
        model.zero_grad(set_to_none=True)
        batch = train_batch(torch, small.vocab_size, 2, 256, dev, seed)
        model(**batch, return_logits=False).backward()
        grads.append({n: p.grad.detach().clone()
                      for n, p in model.named_parameters()})
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model
    res = {}
    for name, kw in PHASE11_OPTIMIZERS:
        side = {}
        for where in ("card", "cpu"):
            d = dev if where == "card" else torch.device("cpu")
            params = {n: t.to(d, copy=True) for n, t in p0.items()}
            opt = make_optimizer(name, kw, None, clip=False)
            for g in grads:
                opt.apply_gradients(params, {n: t.to(d, copy=True)
                                             for n, t in g.items()})
            slots = {f"{n}/{sk}": t for n, e in opt._state["slots"].items()
                     for sk, t in e.items()}
            side[where] = ({n: t.cpu() for n, t in params.items()},
                           {k: t.cpu() for k, t in slots.items()})
            del params, opt, slots
        err_p, at_p = worst_rel(torch, side["card"][0], side["cpu"][0])
        err_s, at_s = (worst_rel(torch, side["card"][1], side["cpu"][1])
                       if side["cpu"][1] else (0.0, None))
        ok = err_p <= UPDATE_RTOL and err_s <= UPDATE_RTOL
        res[name] = {"params_rel": err_p, "params_at": at_p,
                     "slots_rel": err_s, "slots_at": at_s, "ok": ok}
        log(f"optimizers (b) {name}: 2 updates on the card vs the CPU "
            f"(phase 6's layout, fp32): parameters {err_p:.2e} at {at_p}, "
            f"slots {err_s:.2e} at {at_s} (max|diff|/max|cpu|, tol "
            f"{UPDATE_RTOL}: {'ok' if ok else 'FAIL'}); {card}")
        del side
    # D15: bf16 parameters and gradients, Rprop without masters
    side = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        params = {n: t.to(d, torch.bfloat16, copy=True)
                  for n, t in p0.items()}
        opt = make_optimizer("Rprop", {}, None, clip=False)
        for g in grads:
            opt.apply_gradients(params, {n: t.to(d, torch.bfloat16,
                                                 copy=True)
                                         for n, t in g.items()})
        side[where] = {n: t.float().cpu() for n, t in params.items()}
        side[where + " masters"] = len(opt._state["master"])
    masters = side.pop("card masters") + side.pop("cpu masters")
    ulps = max(float(((side["card"][n] - w).abs()
                      / (w.abs() * 2.0 ** -7).clamp_min(1e-30)).max())
               for n, w in side["cpu"].items())
    moved = sum(int((side["cpu"][n] != p0[n].to(torch.bfloat16).float()
                     .cpu()).sum()) for n in p0)
    d15 = {"max_diff_in_bf16_steps": ulps, "elements_moved": moved,
           "masters": masters, "ok": ulps <= 1.0 and moved > 0
           and masters == 0}
    res["rprop_bf16_masterless"] = d15
    log(f"optimizers (b) Rprop, bf16 parameters without masters (D15): "
        f"card vs CPU at most {ulps:.3f} bf16 steps (tol 1), "
        f"{moved} elements moved; {card}")
    del grads, p0, side
    empty_cache(torch, dev)
    return res


def offload_equal(torch, pt, dev, cfg, batch, name, kw, card):
    """(c): one update of phase 7's model from the same gradients with
    the optimizer's state on the card and streamed from pinned host
    memory: parameters, masters and slots equal bit for bit, the
    offloaded state on the host."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.trainer import Trainer
    model = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(10,
                                                                     dev))
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    x = Trainer(model, make_optimizer(name, kw, model))
    x._loss(batch).backward()
    grads = {k: p.grad.detach().clone() for k, p in x.params.items()}
    model.zero_grad(set_to_none=True)
    x.optimizer.apply_gradients(x.params, {k: g.clone() for k, g in
                                           grads.items()}, lr=1e-4)
    after = {k: p.detach().clone() for k, p in x.params.items()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(p0[n])
    del p0
    o = Trainer(model, make_optimizer(name, kw, model),
                offload_opt_state=True)
    t0 = time.perf_counter()
    o.optimizer.apply_gradients(o.params, grads, lr=1e-4)
    sync(torch, dev)
    update_s = time.perf_counter() - t0
    # the parameters against x's result; masters and slots against x's
    # state (x's parameters are the shared model's, now o's)
    live_o = dict(o._live_tensors())
    same = all(torch.equal(p, after[k]) for k, p in o.params.items()) \
        and all(torch.equal(live_o[key].to(dev), t)
                for key, t in x._live_tensors() if key[0] != "params")
    on_host = all(t.is_pinned() for key, t in live_o.items()
                  if key[0] != "params")
    xs = x.optimizer._state
    slots = sorted(next(iter(xs["slots"].values())))
    out = {"same_update_bit_for_bit": same, "state_on_host": on_host,
           "slots": slots, "masters": len(xs["master"]),
           "offloaded_update_s": update_s}
    log(f"optimizers (c) {name} offload: one update with the state "
        f"({len(xs['master'])} masters, slots {slots}) streamed from "
        f"pinned host memory equal to the update on the card bit for bit: "
        f"{same}; state on the host: {on_host}; {update_s:.3f} s; {card}")
    del x, o, model, grads, after, xs, live_o
    empty_cache(torch, dev)
    return out


def lbfgs_leg(torch, pt, dev, small, card):
    """(d): LBFGS(history_size=10, max_iter=10, strong_wolfe) on phase 6's
    fp32 model and one fixed batch: the loss must fall."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import LBFGS
    model = LlamaForCausalLM(small, device=dev, generator=pt.generator(9,
                                                                       dev))
    batch = train_batch(torch, small.vocab_size, 2, 256, dev, 9)
    opt = LBFGS(learning_rate=1.0, max_iter=10, history_size=10,
                line_search_fn="strong_wolfe", parameters=model)
    losses = []

    def closure():
        model.zero_grad(set_to_none=True)
        loss = model(**batch, return_logits=False)
        loss.backward()
        losses.append(float(loss.detach()))
        return loss.detach(), {n: p.grad for n, p in
                               model.named_parameters()}
    sync(torch, dev)
    t0 = time.perf_counter()
    final = float(opt.step(closure))
    sync(torch, dev)
    secs = time.perf_counter() - t0
    out = {"first_loss": losses[0], "final_loss": final,
           "evaluations": opt._n_evals, "s_per_evaluation":
               secs / opt._n_evals, "history_pairs": len(opt._s),
           "history_bytes": opt.history_bytes(), "seconds": secs,
           "params": sum(p.numel() for p in model.parameters()),
           "ok": math.isfinite(final) and final < losses[0]}
    log(f"optimizers (d) LBFGS(history 10, max_iter 10, strong_wolfe), "
        f"phase 6's layout in fp32, one batch: loss {losses[0]:.6f} -> "
        f"{final:.6f} ({'fell' if out['ok'] else 'FAIL: did not fall'}); "
        f"{opt._n_evals} closure evaluations, "
        f"{out['s_per_evaluation'] * 1e3:.1f} ms each; history "
        f"{len(opt._s)} pairs, {out['history_bytes']} bytes; {card}")
    del model, opt
    empty_cache(torch, dev)
    return out


def scaler_leg(torch, pt, dev, small, card):
    """(e): GradScaler over AdamW at phase 6's fp32 layout: a finite
    scaled step equals an unscaled one within UPDATE_RTOL; a NaN batch
    (chaos.nan_batch over an additive mask) is skipped, the parameters
    unchanged bit for bit, and the scale halves after the second."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.testing import chaos
    models = [LlamaForCausalLM(small, device=dev,
                               generator=pt.generator(9, dev))
              for _ in range(2)]
    opts = [make_optimizer("AdamW", {"weight_decay": 0.01}, m)
            for m in models]
    batch = train_batch(torch, small.vocab_size, 2, 256, dev, 9)
    models[0](**batch, return_logits=False).backward()
    opts[0].step()
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15,
                            decr_every_n_nan_or_inf=2)
    scaler.scale(models[1](**batch, return_logits=False)).backward()
    scaler.step(opts[1])
    scaler.update()
    err, at = worst_rel(torch, {n: p.detach()
                                for n, p in models[1].named_parameters()},
                        {n: p.detach().cpu()
                         for n, p in models[0].named_parameters()})
    mask = torch.zeros((2, 1, 1, 256), device=dev)
    poison = chaos.nan_batch({**batch, "attn_mask": mask},
                             fields=["attn_mask"])
    scales, skipped = [scaler.get_loss_scaling()], []
    m = models[1]
    for _ in range(2):
        pre = {n: p.detach().clone() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        scaler.scale(m(**poison, return_logits=False)).backward()
        scaler.step(opts[1])
        skipped.append(scaler._found_inf and all(
            torch.equal(p, pre[n]) for n, p in m.named_parameters()))
        scaler.update()
        scales.append(scaler.get_loss_scaling())
    out = {"finite_step_rel": err, "finite_step_at": at,
           "nan_steps_skipped": skipped, "scales": scales,
           "opt_step": opts[1]._state["step"],
           "ok": (err <= UPDATE_RTOL and all(skipped)
                  and scales == [2.0 ** 15, 2.0 ** 15, 2.0 ** 14]
                  and opts[1]._state["step"] == 1)}
    log(f"optimizers (e) GradScaler (AdamW, phase 6's layout, fp32, scale "
        f"2^15): a finite scaled step vs the unscaled one {err:.2e} at {at} "
        f"(tol {UPDATE_RTOL}); two NaN batches skipped with the parameters "
        f"unchanged bit for bit: {skipped}; scale {scales} (halved after "
        f"2 bad steps), optimizer step {out['opt_step']}: "
        f"{'ok' if out['ok'] else 'FAIL'}; {card}")
    del models, opts, m
    empty_cache(torch, dev)
    return out


def phase_optimizers(torch, pt, dev, make_cfg, b=2, s=4096):
    """Phase 11: (a) each of PHASE11_OPTIMIZERS trains phase 7's model
    (one model, the seeded weights copied back in before each) 2 warm-up
    and 4 timed steps through Trainer.fit; launch counts reset before
    the first and read after the last, every training kernel launched in
    every run, every loss finite; (b) to (e) as the module docstring
    says. Writes nothing to disk. Returns (a)'s launches."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.trainer import Trainer
    card = RESULTS.get("card")
    out = RESULTS.setdefault("optimizers", {"card": card})
    cuda = dev.type == "cuda"
    fails = []
    cfg = make_cfg(num_hidden_layers=4, dtype="bfloat16")
    small = make_cfg(num_hidden_layers=2, dtype="float32",
                     intermediate_size=1024, vocab_size=4096)
    batch = train_batch(torch, cfg.vocab_size, b, s, dev, 10)
    model = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(10,
                                                                     dev))
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    runs = {}
    _build.reset_launches()
    for name, kw in PHASE11_OPTIMIZERS:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(p0[n])
        model.zero_grad(set_to_none=True)
        before = dict(_build.LAUNCHES)
        tr = Trainer(model, make_optimizer(name, kw, model))
        warm = tr.fit(iter([batch] * 2), 2, log_every=1)
        sync(torch, dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        hist = tr.fit(iter([batch] * 4), 4, log_every=1)
        sync(torch, dev)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        st = tr.optimizer._state
        losses = [m.loss for m in warm + hist]
        times = [m.step_time_s for m in hist]
        missing = [k for k in TRAINING_KERNELS
                   if _build.LAUNCHES.get(k, 0) - before.get(k, 0) <= 0]
        runs[name] = {"kwargs": kw, "losses": losses, "step_times_s": times,
                      "median_step_s": statistics.median(times),
                      "peak_memory_bytes": peak,
                      "masters": len(st["master"]),
                      "slots": sorted(next(iter(st["slots"].values()))),
                      "loss_fell": losses[-1] < losses[0],
                      "missing_kernels": missing}
        log(f"optimizers (a) {name}({kw}): 4 timed steps of {b} x {s} "
            f"tokens at llama3_8b widths, 4 layers, bf16: median step "
            f"{runs[name]['median_step_s']:.4f} s, peak memory {peak} bytes "
            f"({(peak or 0) / 1e9:.2f} GB), {len(st['master'])} masters, "
            f"slots {runs[name]['slots']}; losses {losses}; loss fell: "
            f"{runs[name]['loss_fell']}; {card}")
        if missing or not all(math.isfinite(x) for x in losses):
            fails.append(f"{name}: missing {missing}, losses {losses}")
        del tr, st
        model.zero_grad(set_to_none=True)
        empty_cache(torch, dev)
    launches = dict(_build.LAUNCHES)
    out["train"] = runs
    out["launches"] = launches
    log(f"optimizers (a) launches over the 8 runs: {launches}")
    del model, p0
    empty_cache(torch, dev)
    out["updates"] = optimizer_updates(torch, pt, dev, small, card)
    fails += [f"update {k}" for k, v in out["updates"].items()
              if not v["ok"]]
    out["offload"] = {name: offload_equal(torch, pt, dev, cfg, batch, name,
                                          kw, card)
                      for name, kw in PHASE11_OPTIMIZERS
                      if name in ("RMSProp", "Rprop")}
    fails += [f"offload {k}" for k, v in out["offload"].items()
              if not (v["same_update_bit_for_bit"] and v["state_on_host"])]
    out["lbfgs"] = lbfgs_leg(torch, pt, dev, small, card)
    if not out["lbfgs"]["ok"]:
        fails.append("lbfgs")
    out["grad_scaler"] = scaler_leg(torch, pt, dev, small, card)
    if not out["grad_scaler"]["ok"]:
        fails.append("grad_scaler")
    if fails:
        raise SystemExit(f"optimizer checks failed: {fails}")
    return launches


# -- phase 12: the device mesh at world size 1, the ring and the vocab
# shards over virtual ranks ----------------------------------------------

MESH_STEPS = (2, 4)          # warm-up and timed steps of 12(a)
RING_RANKS, RING_S = 4, 16384
CE_SHARDS = 4


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_leg(torch, pt, dev, cfg, batch, mesh=None):
    """2 warm-up and 4 timed steps of phase 7's model (seed 10, AdamW
    1e-4, weight decay 0.01, clip 1.0) through Trainer.fit, plain or
    (``mesh``) through shard_layer, group_sharded_parallel("p_g_os"),
    fleet.distributed_model and distributed_optimizer. Launch counts
    reset before the timed steps and read after. Returns the run's
    numbers and its final parameters (whole, on the card)."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.trainer import Trainer
    model = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(10,
                                                                     dev))
    opt = AdamW(learning_rate=1e-4, parameters=model, weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    if mesh is not None:
        from paddle_tpu_torch.distributed import fleet
        from paddle_tpu_torch.distributed.sharding import \
            group_sharded_parallel
        from paddle_tpu_torch.parallel.api import shard_layer
        shard_layer(model, mesh)
        model, opt, _ = group_sharded_parallel(model, opt, level="p_g_os")
        model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(opt)
    trainer = Trainer(model, opt)
    warm = trainer.fit(iter([batch] * MESH_STEPS[0]), MESH_STEPS[0],
                       log_every=1)
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    hist = trainer.fit(iter([batch] * MESH_STEPS[1]), MESH_STEPS[1],
                       log_every=1)
    sync(torch, dev)
    launches = dict(_build.LAUNCHES)
    times = [m.step_time_s for m in hist]
    info = {"losses": [m.loss for m in warm + hist], "step_times_s": times,
            "median_step_s": statistics.median(times),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
            "launches": launches}
    if mesh is not None:
        from paddle_tpu_torch.parallel.api import full_state_dict
        params = full_state_dict(model)
    else:
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
    del trainer, model, opt
    empty_cache(torch, dev)
    return info, params


def mesh_world1(torch, pt, dev, make_cfg, b, s):
    """(a): phase 7's model and batch through the mesh path at world size
    1 under NCCL (every axis 1, sequence_parallel on) against the plain
    path: losses and final parameters bit for bit."""
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.parallel.mesh import init_parallel_env
    cfg = make_cfg(num_hidden_layers=4, dtype="bfloat16")
    batch = train_batch(torch, cfg.vocab_size, b, s, dev, 10)
    plain, want = mesh_leg(torch, pt, dev, cfg, batch)
    t0 = time.perf_counter()
    init_parallel_env(backend="nccl",
                      init_method=f"tcp://localhost:{free_port()}",
                      world_size=1, rank=0, device="cuda")
    init_s = time.perf_counter() - t0
    from paddle_tpu_torch.parallel.mesh import current_mesh
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
    try:
        hm = current_mesh()
        mesh, got = mesh_leg(torch, pt, dev, make_cfg(
            num_hidden_layers=4, dtype="bfloat16", sequence_parallel=True),
            batch, mesh=hm)
    finally:
        fleet.stop()
        dist.destroy_process_group()
    diff = sorted(n for n in want if not torch.equal(got[n], want[n]))
    out = {"plain": plain, "mesh": mesh, "nccl_init_s": init_s,
           "mesh_shape": hm.shape, "params": len(want),
           "params_differing": diff,
           "losses_equal": plain["losses"] == mesh["losses"],
           "card": RESULTS.get("card")}
    out["ok"] = out["losses_equal"] and not diff and all(
        mesh["launches"][k] > 0 for k in TRAINING_KERNELS)
    log(f"mesh (a) world size 1, NCCL ({init_s:.2f} s to start), mesh "
        f"{hm.shape}: shard_layer + group_sharded_parallel(p_g_os, FSDP2) "
        f"+ fleet, sequence_parallel on; {MESH_STEPS[0]} + {MESH_STEPS[1]} "
        f"steps of {b} x {s} tokens at llama3_8b widths, 4 layers, bf16: "
        f"losses equal to the plain path's: {out['losses_equal']} "
        f"({mesh['losses']}); parameters differing: {diff or 'none'} of "
        f"{len(want)}; median step {mesh['median_step_s']:.4f} s against "
        f"{plain['median_step_s']:.4f} s plain; peak memory "
        f"{mesh['peak_memory_bytes']} against {plain['peak_memory_bytes']} "
        f"bytes; launches of the timed steps {mesh['launches']}; "
        f"{card_line()}")
    del want, got
    empty_cache(torch, dev)
    return out


def virtual_ring(torch, q, k, v, scale, causal, n, seg=None, dout=None):
    """The ring of ``parallel.ring_attention`` over ``n`` virtual ranks in
    one process: rank r's queries are block r, and at step t it holds
    the K/V block of rank (r - t) mod n (the exchange is indexing). The
    same module-level step and merge functions as the distributed ring;
    dk and dv summed per block in step order, as they ride the ring.
    Returns (out, lse) or, with ``dout``, (out, lse, dq, dk, dv), each
    whole along the sequence."""
    from paddle_tpu_torch.ops.attention import NEG_INF
    from paddle_tpu_torch.parallel import ring_attention as ra
    sl = q.shape[1] // n
    blk = (lambda t, i: None if t is None else
           t[:, i * sl:(i + 1) * sl])
    outs, lses = [], []
    for r in range(n):
        b, _, h, d = q.shape
        out = torch.zeros((b, sl, h, d), dtype=torch.float32,
                          device=q.device)
        lse = torch.full((b, h, sl), NEG_INF, dtype=torch.float32,
                         device=q.device)
        for t in range(n):
            src = (r - t) % n
            res = ra.ring_fwd_step(r, t, n, causal, scale, blk(q, r),
                                   blk(k, src), blk(v, src), blk(seg, r),
                                   blk(seg, src))
            if res is not None:
                out, lse = ra.merge_norm(out, lse, *res)
        outs.append(out.to(q.dtype))
        lses.append(lse)
    if dout is None:
        return torch.cat(outs, 1), torch.cat(lses, 2)
    dq = [torch.zeros_like(outs[0], dtype=torch.float32) for _ in range(n)]
    dk = [torch.zeros_like(blk(k, 0), dtype=torch.float32)
          for _ in range(n)]
    dv = [torch.zeros_like(blk(v, 0), dtype=torch.float32)
          for _ in range(n)]
    deltas = [(outs[r].float() * blk(dout, r).float()).sum(-1).transpose(
        1, 2).contiguous() for r in range(n)]
    for t in range(n):
        for r in range(n):
            src = (r - t) % n
            res = ra.ring_bwd_step(r, t, n, causal, scale, blk(q, r),
                                   blk(k, src), blk(v, src), outs[r],
                                   lses[r], blk(dout, r), blk(seg, r),
                                   blk(seg, src), deltas[r])
            if res is not None:
                dq[r] += res[0].float()
                dk[src] += res[1].float()
                dv[src] += res[2].float()
    return (torch.cat(outs, 1), torch.cat(lses, 2),
            torch.cat(dq, 1).to(q.dtype), torch.cat(dk, 1).to(k.dtype),
            torch.cat(dv, 1).to(v.dtype))


def ring_block_ms(torch, q, k, v, dout, outs, scale, n, flush):
    """The causal ring's block kernels one by one (every launch the ring
    makes, each timed alone): (forward ms summed, backward ms summed).
    As the distributed ring, each rank's delta = rowsum(out * dout) and
    its contiguous lse block are made once, outside the timed calls."""
    from paddle_tpu_torch.parallel import ring_attention as ra
    sl = q.shape[1] // n
    blk = lambda t, i: t[:, i * sl:(i + 1) * sl].contiguous()
    o, lse = outs
    lses = [lse[:, :, r * sl:(r + 1) * sl].contiguous() for r in range(n)]
    deltas = [(blk(o, r).float() * blk(dout, r).float()).sum(-1).transpose(
        1, 2).contiguous() for r in range(n)]
    fwd = bwd = 0.0
    for r in range(n):
        for t in range(n):
            src = (r - t) % n
            if ra.ring_case(r, t, n, True) == "skip":
                continue
            qb, kb, vb = blk(q, r), blk(k, src), blk(v, src)
            ob, db = blk(o, r), blk(dout, r)
            fwd += timed_ms(torch, lambda: ra.ring_fwd_step(
                r, t, n, True, scale, qb, kb, vb), flush, reps=5, warmup=1)
            bwd += timed_ms(torch, lambda: ra.ring_bwd_step(
                r, t, n, True, scale, qb, kb, vb, ob, lses[r], db,
                delta=deltas[r]), flush, reps=5, warmup=1)
    return fwd, bwd


def ring_virtual(torch, dev):
    """(b): the causal ring over 4 virtual ranks at b = 1, s = 16384 (4
    blocks of 4096), 32 / 8 heads, d = 128, bf16, against flash over the
    whole sequence: out and lse, then dq, dk and dv from a seeded dout,
    without and with four uneven packed segments across the blocks; the
    launches (4 diagonal and 6 full blocks a direction, none for the 6
    skipped); rows whose segment has no key in a block come back at lse
    = -1e30 and out 0; two backward runs equal bit for bit; the block
    kernels' summed times beside the whole-sequence kernel's."""
    from paddle_tpu_torch.ops.attention import NEG_INF
    from paddle_tpu_torch.ops.kernels import _build, flash_attention as fa
    from paddle_tpu_torch.parallel import ring_attention as ra
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    n, S, H, HKV, D = RING_RANKS, RING_S, 32, 8, 128
    scale = 1.0 / math.sqrt(D)
    mk = lambda h: torch.randn((1, S, h, D), generator=g,
                               device=dev).to(torch.bfloat16)
    q, k, v, dout = mk(H), mk(HKV), mk(HKV), mk(H)
    lens = (3000, 5000, 2500, S - 10500)
    seg = torch.repeat_interleave(
        torch.arange(4, device=dev, dtype=torch.int32),
        torch.tensor(lens, device=dev))[None].contiguous()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    out = {"shape": [1, S, H, HKV, D], "ranks": n,
           "bytes": {"q": q.numel() * 2, "k": k.numel() * 2,
                     "v": v.numel() * 2, "fp32_state": q.numel() * 4},
           "card": RESULTS.get("card")}
    ok = True
    for name, sg in (("causal", None), ("causal_segments", seg)):
        _build.reset_launches()
        got = virtual_ring(torch, q, k, v, scale, True, n, sg, dout)
        sync(torch, dev)
        launches = {kk: _build.LAUNCHES[kk] for kk in ("flash_fwd",
                                                       "flash_bwd")}
        w_o, w_l = fa.flash_fwd(q, k, v, True, scale, sg, sg)
        delta = (w_o.float() * dout.float()).sum(-1).transpose(
            1, 2).contiguous()
        w_dq, w_dk, w_dv = fa.flash_bwd(q, k, v, dout, w_l, delta, True,
                                        scale, sg, sg)
        res = flash_compare(torch, [(got[0], w_o), (got[2], w_dq),
                                    (got[3], w_dk), (got[4], w_dv)],
                            "bfloat16")
        lse_err = float((got[1] - w_l).abs().max())
        again = virtual_ring(torch, q, k, v, scale, True, n, sg, dout)
        same = all(torch.equal(a, b) for a, b in zip(got[2:], again[2:]))
        case = {"max_abs_err": res[0], "row_err": res[3],
                "lse_max_abs_err": lse_err, "launches": launches,
                "backward_bit_for_bit": same,
                "ok": (res[2] and lse_err <= ROW_TOL and same
                       and launches == {"flash_fwd": 10, "flash_bwd": 10})}
        if sg is not None:
            # rank 1 at step 1 holds block 0 (segments 0 and 1): its rows
            # of segment 2 (positions 8000 .. 8191) have no key there
            sl = S // n
            o1, l1 = ra.ring_fwd_step(1, 1, n, True, scale,
                                      q[:, sl:2 * sl], k[:, :sl], v[:, :sl],
                                      seg[:, sl:2 * sl], seg[:, :sl])
            rows = slice(8000 - sl, sl)
            case["masked_rows"] = int(l1[:, :, rows].numel() // H)
            case["masked_rows_ok"] = bool(
                (l1[:, :, rows] == NEG_INF).all()
                and (o1[:, rows] == 0).all())
            case["ok"] = case["ok"] and case["masked_rows_ok"]
        out[name] = case
        ok = ok and case["ok"]
        log(f"mesh (b) ring over {n} virtual ranks ({name}), b=1, s={S}, "
            f"{H}/{HKV} heads, d={D}, bf16: out/dq/dk/dv vs whole-sequence "
            f"flash max abs {res[0]:.3e}, row err {res[3]:.3e} (tol "
            f"{ROW_TOL}), lse max abs {lse_err:.3e}; launches {launches} "
            f"(want 10 + 10); backward bit for bit: {same}"
            + (f"; {case['masked_rows']} rows with no key in a block at "
               f"lse -1e30, out 0: {case['masked_rows_ok']}"
               if sg is not None else "") + f"; {card_line()}")
        del got, again, w_o, w_dq, w_dk, w_dv
    o, lse = virtual_ring(torch, q, k, v, scale, True, n)
    fwd, bwd = ring_block_ms(torch, q, k, v, dout, (o, lse), scale, n, flush)
    w_o, w_l = fa.flash_fwd(q, k, v, True, scale)
    delta = (w_o.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()
    full_f = timed_ms(torch, lambda: fa.flash_fwd(q, k, v, True, scale),
                      flush, reps=5, warmup=1)
    full_b = timed_ms(torch, lambda: fa.flash_bwd(q, k, v, dout, w_l, delta,
                                                  True, scale),
                      flush, reps=5, warmup=1)
    out["ms"] = {"blocks_fwd": fwd, "blocks_bwd": bwd, "whole_fwd": full_f,
                 "whole_bwd": full_b}
    log(f"mesh (b) the ring's 10 forward block kernels {fwd:.3f} ms and 10 "
        f"backward {bwd:.3f} ms (summed, each timed alone) against one "
        f"whole-sequence flash forward {full_f:.3f} ms and backward "
        f"{full_b:.3f} ms; bytes {out['bytes']}; {card_line()}")
    out["ok"] = ok
    del q, k, v, dout, o, lse, w_o, w_l, delta
    empty_cache(torch, dev)
    return out


def vocab_shards(torch, dev):
    """(c): the vocab-parallel CE head over 4 virtual shards (N = 8192, H
    = 4096, V = 128256: 32064 columns a shard) against the whole-vocab
    fused head: per-shard lse_and_target kernels with the labels shifted
    by the shard's offset, merged as the distributed head merges them
    (``mp_layers.merge_shard_stats``); nll, dh and dW (the shards'
    concatenated) within 2e-2; ignored rows and labels in every shard;
    the four shards' time beside one whole-vocab call."""
    from paddle_tpu_torch.ops import vocab_ce
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.parallel.mp_layers import merge_shard_stats
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    N, H, V, n = 8192, 4096, 128256, CE_SHARDS
    per = V // n
    h0 = torch.randn((N, H), generator=g, device=dev).to(torch.bfloat16)
    w0 = (0.02 * torch.randn((H, V), generator=g, device=dev)).to(
        torch.bfloat16)
    labels = torch.randint(0, V, (N,), generator=g, device=dev)
    labels[::61] = -100
    valid = labels != -100
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)

    def whole():
        h, w = h0.clone().requires_grad_(), w0.clone().requires_grad_()
        nll = vocab_ce.fused_linear_cross_entropy(h, w, labels,
                                                  reduction="none")
        nll.sum().backward()
        return nll.detach(), h.grad, w.grad

    def sharded():
        h = h0.clone().requires_grad_()
        ws = [w0[:, s * per:(s + 1) * per].clone().requires_grad_()
              for s in range(n)]
        stats = [vocab_ce.lse_and_target(
            h, ws[s], (torch.where(valid, labels, -1) - s * per).to(
                torch.int32)) for s in range(n)]
        nll = merge_shard_stats([a for a, _ in stats], [b for _, b in stats],
                                valid)
        nll.sum().backward()
        return nll.detach(), h.grad, torch.cat([w.grad for w in ws], 1)
    _build.reset_launches()
    got = sharded()
    sync(torch, dev)
    launches = {k: _build.LAUNCHES[k] for k in CE_KERNELS}
    want = whole()
    nll_err = float((got[0] - want[0]).abs().max())
    dh_err = row_err(torch, got[1], want[1])
    dw_err = row_err(torch, got[2].t(), want[2].t())
    shards_hit = sorted(set((labels[valid] // per).tolist()))
    out = {"N": N, "H": H, "V": V, "shards": n, "per_shard": per,
           "nll_max_abs_err": nll_err, "dh_row_err": dh_err,
           "dw_col_err": dw_err, "ignored_rows": int((~valid).sum()),
           "shards_with_labels": shards_hit, "launches": launches,
           "card": RESULTS.get("card")}
    out["ok"] = (nll_err <= ROW_TOL and dh_err <= ROW_TOL
                 and dw_err <= ROW_TOL and shards_hit == list(range(n))
                 and launches["vocab_ce_fwd"] == n)
    del got, want
    with torch.no_grad():
        lab32 = [(torch.where(valid, labels, -1) - s * per).to(torch.int32)
                 for s in range(n)]
        wsc = [w0[:, s * per:(s + 1) * per].contiguous() for s in range(n)]
        shard_f = timed_ms(torch, lambda: [vocab_ce.lse_and_target(
            h0, wsc[s], lab32[s]) for s in range(n)], flush, reps=5,
            warmup=1)
        whole_f = timed_ms(torch, lambda: vocab_ce.lse_and_target(
            h0, w0, torch.where(valid, labels, -1).to(torch.int32)), flush,
            reps=5, warmup=1)
    shard_fb = timed_ms(torch, sharded, flush, reps=3, warmup=1)
    whole_fb = timed_ms(torch, whole, flush, reps=3, warmup=1)
    out["ms"] = {"shards_fwd": shard_f, "whole_fwd": whole_f,
                 "shards_fwd_bwd": shard_fb, "whole_fwd_bwd": whole_fb}
    log(f"mesh (c) vocab-parallel CE over {n} virtual shards, N={N}, H={H}, "
        f"V={V} ({per} columns a shard), bf16: nll max abs {nll_err:.3e}, "
        f"dh row err {dh_err:.3e}, dW column err {dw_err:.3e} (tol "
        f"{ROW_TOL}); {out['ignored_rows']} ignored rows, labels in shards "
        f"{shards_hit}; launches {launches}; forward {shard_f:.3f} ms for the "
        f"{n} shards against {whole_f:.3f} ms whole, forward + backward "
        f"{shard_fb:.3f} against {whole_fb:.3f} ms (the shards' include "
        f"their W copies); {'ok' if out['ok'] else 'FAIL'}; {card_line()}")
    del h0, w0, wsc
    empty_cache(torch, dev)
    return out


def phase_mesh(torch, pt, dev, make_cfg, b=2, s=4096):
    """Phase 12 (see the module docstring): (a) the mesh path at world
    size 1, (b) the ring over virtual ranks, (c) the vocab-parallel CE
    head over virtual shards. Writes nothing to disk. Returns (a)'s
    launches."""
    out = RESULTS.setdefault("mesh", {})
    out["world1"] = mesh_world1(torch, pt, dev, make_cfg, b, s)
    out["ring"] = ring_virtual(torch, dev)
    out["vocab_shards"] = vocab_shards(torch, dev)
    fails = [k for k in ("world1", "ring", "vocab_shards")
             if not out[k]["ok"]]
    if fails:
        raise SystemExit(f"mesh checks failed: {fails}")
    return out["world1"]["mesh"]["launches"]


PIPE_STAGES, PIPE_MICRO = 4, 4      # phase 13(a): virtual stages, microbatches
EP_RANKS, EP_TOKENS = 4, 8192       # phase 13(b): virtual ep ranks, tokens


def pipe_from(plain, schedule):
    """``LlamaForCausalLMPipe`` of PIPE_STAGES virtual stages and
    PIPE_MICRO microbatches with the weights of the Llama ``plain``."""
    from paddle_tpu_torch.models import LlamaForCausalLMPipe
    dev = next(plain.parameters()).device
    pipe = LlamaForCausalLMPipe(plain.cfg, num_stages=PIPE_STAGES,
                                num_microbatches=PIPE_MICRO,
                                pp_schedule=schedule, device=dev)
    pipe.load_from_unpipelined(plain)
    return pipe


def pipe_model(schedule):
    """A model factory for ``train_run``: :func:`pipe_from` the
    unpipelined Llama that the same seed draws."""
    def make(cfg, device, generator):
        from paddle_tpu_torch.models import LlamaForCausalLM
        return pipe_from(LlamaForCausalLM(cfg, device=device,
                                          generator=generator), schedule)
    return make


def grad_row_err(torch, got, want) -> float:
    """row_err, a 1-D tensor (a norm weight) taken as one row."""
    if got.dim() == 1:
        got, want = got[None], want[None]
    return row_err(torch, got, want)


def pipe_first_step(torch, pt, dev, cfg, batch):
    """13(a)'s gate: the unpipelined Llama's first forward + backward and
    the 1F1B pipe's fused step from its weights on the same batch: the
    loss (rtol BF16_LOSS_RTOL) and every gradient per row (ROW_TOL)."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.models.llama import pipe_name
    plain = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(10, dev))
    pipe = pipe_from(plain, "1f1b")
    loss_p = plain(**batch, return_logits=False)
    loss_p.backward()
    want = {pipe_name(n): p.grad for n, p in plain.named_parameters()}
    lp = float(loss_p.detach())
    del plain, loss_p
    t0 = time.perf_counter()
    loss_q, _ = pipe.loss_and_grads(**batch)
    lq = float(loss_q)
    fused_s = time.perf_counter() - t0
    errs = {n: grad_row_err(torch, p.grad, want[n])
            for n, p in pipe.named_parameters()}
    worst = max(errs, key=errs.get)
    out = {"loss_plain": lp, "loss_pipe": lq, "grad_row_err": errs,
           "worst": worst, "first_step_s": fused_s,
           "stats": dict(pipe.pipe_stats)}
    out["ok"] = (abs(lq - lp) <= BF16_LOSS_RTOL * abs(lp)
                 and errs[worst] <= ROW_TOL and len(errs) == len(want))
    del pipe, want
    empty_cache(torch, dev)
    return out


def pipeline_virtual(torch, pt, dev, make_cfg, b, s):
    """13(a): the gate (:func:`pipe_first_step`), then 2 + 4 Trainer
    steps each of the 1F1B pipe, the GPipe pipe and the plain path on
    phase 7's widths (``train_run``: AdamW, clip 1.0, launches counted in
    the timed steps)."""
    cfg = make_cfg(num_hidden_layers=4, dtype="bfloat16")
    batch = train_batch(torch, cfg.vocab_size, b, s, dev, 13)
    out = {"first_step": pipe_first_step(torch, pt, dev, cfg, batch)}
    for name, cls in (("1f1b", pipe_model("1f1b")),
                      ("gpipe", pipe_model("gpipe")), ("plain", None)):
        out[name] = train_run(torch, pt, dev, cfg, batch, *MESH_STEPS,
                              model_cls=cls)
    first, run = out["first_step"], out["1f1b"]
    missing = [k for k in TRAINING_KERNELS if run["launches"][k] <= 0]
    finite = all(math.isfinite(x) for x in run["losses"])
    out["ok"] = first["ok"] and not missing and finite
    log(f"pipeline (a) {PIPE_STAGES} virtual stages, {PIPE_MICRO} "
        f"microbatches, llama3_8b widths, 4 layers, bf16, {b} x {s} tokens: "
        f"first 1F1B step from the unpipelined weights: loss "
        f"{first['loss_pipe']} against {first['loss_plain']} (rtol "
        f"{BF16_LOSS_RTOL}), worst gradient row error "
        f"{first['grad_row_err'][first['worst']]:.2e} at {first['worst']} "
        f"(tol {ROW_TOL}), microbatches held per stage at the peak "
        f"{first['stats'].get('peak_live')}: "
        f"{'ok' if first['ok'] else 'FAIL'}; median step 1F1B "
        f"{run['median_step_s']:.4f} s, GPipe "
        f"{out['gpipe']['median_step_s']:.4f} s, plain "
        f"{out['plain']['median_step_s']:.4f} s; peak memory 1F1B "
        f"{run['peak_memory_bytes']}, GPipe "
        f"{out['gpipe']['peak_memory_bytes']}, plain "
        f"{out['plain']['peak_memory_bytes']} bytes (forward + backward "
        f"alone {run['fwd_bwd_peak_memory_bytes']}, "
        f"{out['gpipe']['fwd_bwd_peak_memory_bytes']}, "
        f"{out['plain']['fwd_bwd_peak_memory_bytes']}); 1F1B losses "
        f"{run['losses']}; launches not made: {missing or 'none'}; "
        f"{card_line()}")
    return out


def ep_virtual(torch, pt, dev, d=2048, f=1408, e=64, k=6,
               tokens=EP_TOKENS):
    """13(b): one dropless MoELayer at DeepSeekMoE-16B widths (hidden
    2048, 64 experts of 1408, top 6, bf16) over EP_TOKENS tokens split
    among EP_RANKS virtual ep ranks (``forward_virtual_ep``) against the
    same layer on the whole batch: outputs, input gradients and weight
    gradients per row (ROW_TOL) and the aux loss; every grouped launch
    of the ep pass on the wgmma route; the host syncs of its forward and
    backward counted (``set_sync_debug_mode("warn")``) beside the split
    reads; both passes timed."""
    import warnings
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.parallel.moe import EP_HOST_READS, MoELayer
    layer = MoELayer(d, f, e, top_k=k, capacity_factor=None,
                     dtype="bfloat16", device=dev,
                     generator=pt.generator(14, dev))
    g = pt.generator(15, dev)
    x = torch.randn((EP_RANKS, tokens // EP_RANKS, d), device=dev,
                    dtype=torch.bfloat16, generator=g)
    dout = torch.randn(x.shape, device=dev, dtype=torch.bfloat16,
                       generator=g)

    def whole():
        xi = x.detach().clone().requires_grad_(True)
        out, aux = layer(xi.reshape(1, tokens, d))
        ((out.float() * dout.reshape(out.shape).float()).sum()
         + aux).backward()
        return out.reshape(x.shape), aux, xi.grad

    def lanes():
        xs = [t.detach().clone().requires_grad_(True)
              for t in x.unbind(0)]
        outs, aux = layer.forward_virtual_ep(
            [t[None] for t in xs], EP_RANKS)
        (sum((o[0].float() * d.float()).sum()
             for o, d in zip(outs, dout.unbind(0))) + aux).backward()
        return (torch.stack([o[0] for o in outs]), aux,
                torch.stack([t.grad for t in xs]))

    def run(fn):
        layer.zero_grad(set_to_none=True)
        res = fn()
        grads = {n: p.grad for n, p in layer.named_parameters()}
        return res, grads
    (want, aux_w, dx_w), gw = run(whole)
    run(lanes)                                         # warm-up
    sync(torch, dev)
    _build.reset_launches()
    reads = EP_HOST_READS[0]
    cuda = dev.type == "cuda"
    mode = torch.cuda.get_sync_debug_mode() if cuda else None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            (got, aux_g, dx_g), gg = run(lanes)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)
    sync(torch, dev)
    reads = EP_HOST_READS[0] - reads
    launches = dict(_build.LAUNCHES)
    # where each sync was asked for (the warning's Python line)
    sites = [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    syncs = len(sites)
    errs = {"out": row_err(torch, got, want), "dx": row_err(torch, dx_g,
                                                            dx_w)}
    errs.update({n: grad_row_err(torch, gg[n], gw[n]) for n in gw})
    aux_err = abs(float(aux_g) - float(aux_w)) / abs(float(aux_w))

    def timed(fn):
        if not cuda:
            return None
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ts = []
        for _ in range(3):
            sync(torch, dev)
            ev[0].record()
            run(fn)
            ev[1].record()
            sync(torch, dev)
            ts.append(ev[0].elapsed_time(ev[1]))
        return statistics.median(ts)
    ms = {"ep_virtual": timed(lanes), "whole": timed(whole)}
    wgmma = all(launches.get(k, 0) > 0
                and launches.get(k + "_wgmma", 0) == launches[k]
                for k in ("grouped_matmul", "grouped_matmul_dw"))
    out = {"row_err": errs, "aux_rel_err": aux_err, "launches": {
        k: launches.get(k, 0) for k in ("grouped_matmul",
                                         "grouped_matmul_dw")},
        "launches_all": launches, "split_reads": reads,
        "host_syncs": syncs, "sync_sites": sites, "ms": ms,
        "card": RESULTS.get("card")}
    out["ok"] = (max(errs.values()) <= ROW_TOL and aux_err <= 1e-3
                 and wgmma)
    log(f"pipeline (b) dropless ep over {EP_RANKS} virtual ranks, "
        f"hidden {d}, {e} experts of {f}, top {k}, {tokens} "
        f"tokens, bf16: worst row error {max(errs.values()):.2e} (tol "
        f"{ROW_TOL}; {errs}), aux relative error {aux_err:.2e}; grouped "
        f"launches {out['launches']}, all on wgmma: {wgmma}; host syncs in "
        f"forward + backward {syncs} at {sites} (split-size reads "
        f"{out['split_reads']})"
        f"; fwd + bwd {ms['ep_virtual']} ms over the ranks against "
        f"{ms['whole']} ms whole: {'ok' if out['ok'] else 'FAIL'}; "
        f"{card_line()}")
    del layer, x, dout, want, got, gw, gg
    empty_cache(torch, dev)
    return out


def phase_pipeline(torch, pt, dev, make_cfg, b=4, s=4096):
    """Phase 13 (see the module docstring): (a) the pipelined Llama over
    virtual stages, (b) dropless expert parallelism over virtual ranks.
    Writes nothing to disk."""
    out = RESULTS.setdefault("pipeline", {})
    out["pipe"] = pipeline_virtual(torch, pt, dev, make_cfg, b, s)
    out["ep"] = ep_virtual(torch, pt, dev)
    fails = [k for k in ("pipe", "ep") if not out[k]["ok"]]
    if fails:
        raise SystemExit(f"pipeline checks failed: {fails}")
    return out["pipe"]["1f1b"]["launches"], out["ep"]["launches"]


# -- phase 14: the launcher, DistModel, the projection's inputs ------------

LAUNCH_LAYERS = 2            # 14(a)'s model depth
LAUNCH_STEPS = (2, 4)        # warm-up and timed steps of 14(a) and (b)
# the worker's exits on its first starts: a planted failure, then a
# resumable exit (preemption); the third start trains
LAUNCH_EXITS = (3, 75)


def launch_steps(torch, pt, dev, layers, runner="trainer"):
    """Phase 7's model (Llama-3-8B widths, ``layers`` layers, bf16,
    seed 10, AdamW(1e-4, weight_decay=0.01), clip 1.0) and batch (2 x
    4096, seed 10): 2 + 4 steps through the Trainer or, with ``runner``
    "distmodel", ``distributed.compat.DistModel``. Returns the losses
    and the launch counts of the timed steps."""
    from paddle_tpu_torch.distributed.compat import to_static
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.trainer import Trainer
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=layers, dtype="bfloat16")
    batch = train_batch(torch, cfg.vocab_size, 2, 4096, dev, 10)
    model = LlamaForCausalLM(cfg, device=dev,
                             generator=pt.generator(10, dev))
    opt = AdamW(learning_rate=1e-4, parameters=model, weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    if runner == "distmodel":
        dm = to_static(model, optimizer=opt)
        dm.train()

        def step():
            return dm(batch["input_ids"], batch["labels"])
    else:
        tr = Trainer(model, opt)

        def step():
            return tr.train_step(batch)
    warm, n = LAUNCH_STEPS
    losses = [float(step()) for _ in range(warm)]
    sync(torch, dev)
    _build.reset_launches()
    losses += [float(step()) for _ in range(n)]
    sync(torch, dev)
    launches = dict(_build.LAUNCHES)
    del model, opt
    empty_cache(torch, dev)
    return losses, launches


def launch_worker() -> int:
    """``--launch-worker OUT --starts FILE``: one rank of phase 14(a)'s
    pod. Counts its starts in FILE; exits with LAUNCH_EXITS on the first
    ones, then takes the steps of :func:`launch_steps` on the card the
    launcher names and writes the losses, launches and environment to
    OUT."""
    out = sys.argv[sys.argv.index("--launch-worker") + 1]
    starts = sys.argv[sys.argv.index("--starts") + 1]
    n = int(open(starts).read()) if os.path.exists(starts) else 0
    with open(starts, "w") as f:
        f.write(str(n + 1))
    if n < len(LAUNCH_EXITS):
        return LAUNCH_EXITS[n]
    import torch
    if not torch.cuda.is_available():
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.parallel.mesh import local_card, pod_bootstrap_env
    dev = torch.device("cuda", local_card(int(os.environ["LOCAL_RANK"])))
    torch.cuda.set_device(dev)
    _build.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    losses, launches = launch_steps(torch, pt, dev, LAUNCH_LAYERS)
    env = {k: os.environ.get(k) for k in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "PADDLE_TRAINER_ID",
        "PADDLE_TRAINERS_NUM", "CUDA_VISIBLE_DEVICES",
        "FLAGS_selected_gpus")}
    with open(out, "w") as f:
        json.dump({"losses": losses, "launches": launches, "env": env,
                   "bootstrap": pod_bootstrap_env(), "device": str(dev),
                   "uuid": card_uuid(torch, dev), "card": pt.device_info()},
                  f)
    return 0


def card_uuid(torch, dev) -> str:
    """The card's UUID, which names it whatever a process sees of the
    machine's cards."""
    return str(torch.cuda.get_device_properties(dev).uuid)


def visible_entry(torch, dev) -> str:
    """This process's card as the launcher's ``--devices`` takes it: its
    entry in CUDA_VISIBLE_DEVICES (an index or a UUID), else its
    index."""
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    return vis.split(",")[i].strip() if vis else str(i)


def phase_launcher(torch, pt, dev, make_cfg):
    """Phase 14 (see the module docstring). Returns the launch counts of
    the launched worker's timed steps, DistModel's and the bench's."""
    from paddle_tpu_torch.distributed.launch import LaunchConfig, launch
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.parallel.scale import train_state_bytes
    from paddle_tpu_torch.tools.bench_8b_layer import measure
    out = RESULTS.setdefault("launcher", {})
    fails = []
    # (a) the launcher: a planted failure, a resumable exit, the steps
    logdir = os.path.join(ROOT_OUT, "launch_logs")
    os.makedirs(logdir, exist_ok=True)
    starts = os.path.join(logdir, "starts")
    result = os.path.join(logdir, "worker.json")
    for f in (starts, result):
        if os.path.exists(f):
            os.remove(f)
    # the worker is shown this process's card alone
    cfg = LaunchConfig(nproc_per_node=1, log_dir=logdir, max_restarts=1,
                       devices=visible_entry(torch, dev))
    t0 = time.perf_counter()
    code = launch(cfg, os.path.abspath(__file__),
                  ["--launch-worker", result, "--starts", starts])
    secs = time.perf_counter() - t0
    worker = (json.load(open(result)) if os.path.exists(result)
              else {"losses": [], "launches": {}})
    n_starts = int(open(starts).read())
    ref, _ = launch_steps(torch, pt, dev, LAUNCH_LAYERS)
    missing = [k for k in TRAINING_KERNELS
               if worker["launches"].get(k, 0) <= 0]
    mine = card_uuid(torch, dev)
    a = {"exit_code": code, "starts": n_starts, "seconds": secs,
         "losses": worker["losses"], "in_process_losses": ref,
         "equal": worker["losses"] == ref, "env": worker.get("env"),
         "card_uuid": mine, "worker_card_uuid": worker.get("uuid"),
         "same_card": worker.get("uuid") == mine,
         "missing_kernels": missing}
    out["launch"] = a
    log(f"launcher: exit {code} after {n_starts} starts (3, 75, then the "
        f"steps) in {secs:.1f} s; worker env {worker.get('env')}, card "
        f"{worker.get('uuid')} (this process's {mine}); losses "
        f"{worker['losses']} vs in-process {ref}: equal {a['equal']}")
    if code != 0 or n_starts != len(LAUNCH_EXITS) + 1 or not a["equal"] \
            or not a["same_card"] or missing:
        fails.append("launch")
    # (b) DistModel against the Trainer
    dm, dm_launches = launch_steps(torch, pt, dev, 4, "distmodel")
    tr, _ = launch_steps(torch, pt, dev, 4)
    out["dist_model"] = {"losses": dm, "trainer_losses": tr,
                         "equal": dm == tr}
    log(f"DistModel: losses {dm} vs Trainer {tr}: equal {dm == tr}")
    if dm != tr:
        fails.append("dist_model")
    # (c) the projection's inputs, and the memory model against phase 7
    m = measure()
    out["bench_8b_layer"] = m
    log(f"bench_8b_layer (b 1, s 8192, bf16, {m['device']}): layer "
        f"{m['layer_us']:.1f} us ({m.get('layer_tflops')} TFLOP/s), "
        f"recompute {m['layer_remat_us']:.1f} us, head "
        f"{m['head_us_per_token']:.4f} us/token (linearity "
        f"{m['head_linearity']:.4f}), embedding {m['embed_us']:.1f} us")
    missing = [k for k in TRAINING_KERNELS if m["launches"].get(k, 0) <= 0]
    if missing:
        fails.append(f"bench_8b_layer missing {missing}")
    cfg7 = make_cfg(num_hidden_layers=4, dtype="bfloat16")
    model = LlamaForCausalLM(cfg7, device="meta")
    est = train_state_bytes(model, {}, seq_len=4096, microbatch_size=2,
                            recompute="none")
    peak = RESULTS.get("training", {}).get("peak_memory_bytes")
    out["scale"] = {"estimate": est, "measured_peak_bytes": peak,
                    "ratio": est["total"] / peak if peak else None}
    log(f"scale.train_state_bytes, phase 7's configuration: "
        f"{est['total']:.0f} bytes (params {est['params']:.0f}, "
        f"optimizer {est['optimizer']:.0f}, activations "
        f"{est['activations']:.0f}) against phase 7's measured peak "
        f"{peak}: ratio {out['scale']['ratio']}")
    if fails:
        raise SystemExit(f"phase 14 checks failed: {fails}")
    return worker["launches"], dm_launches, m["launches"]


PLAN_DEVICES = (4, 8)        # 15(a): the meshes planned
PLAN_BATCH, PLAN_SEQ = 8, 8192   # 15(a): global batch and sequence
RESHARD_TARGETS = ("tp2", "tp4", "dp2_tp2", "fsdp4")     # 15(c)


def plan_meshes(torch, dev, make_cfg):
    """15(a): the planner for Llama-3-8B on PLAN_DEVICES cards. Returns
    (results, failures)."""
    from paddle_tpu_torch.distributed.auto_parallel import (hbm_capacity,
                                                            plan)
    from paddle_tpu_torch.observability.costs import device_spec
    from paddle_tpu_torch.observability.costs.device_db import H100_LINK_BW
    cfg = make_cfg(dtype="bfloat16", recompute="full")
    cap = hbm_capacity() if dev.type == "cuda" else None
    spec = device_spec(link_bw=H100_LINK_BW)
    before = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
              else 0)
    out, fails = {}, []

    def one(n):
        t0 = time.perf_counter()
        report = plan(cfg, n_devices=n, global_batch=PLAN_BATCH,
                      seq_len=PLAN_SEQ, drift="ignore", spec=spec,
                      model_name="llama3_8b")
        return report, time.perf_counter() - t0
    # each plan's census runs in a child process of its own: side by side
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(PLAN_DEVICES)) as ex:
        done = list(ex.map(one, PLAN_DEVICES))
    for n, (report, secs) in zip(PLAN_DEVICES, done):
        ranked = report.ranked
        mem_pruned = [str(pc.config) for pc in report.pruned
                      if pc.reason.startswith("HBM infeasible")]
        r = {"seconds": secs, "capacity_bytes": cap,
             "chosen": str(report.chosen.config) if ranked else None,
             "top": [pc.as_dict() for pc in ranked[:5]],
             "ranked": len(ranked), "pruned_by_memory": len(mem_pruned),
             "pruned": {str(pc.config): pc.reason for pc in report.pruned},
             "over_capacity": [str(pc.config) for pc in ranked
                               if cap and pc.hbm_high_water_bytes > cap],
             "no_census": [str(pc.config) for pc in ranked
                           if pc.config.size > 1
                           and not sum(pc.graph.census_counts.values())],
             "census_failed": [str(pc.config) for pc in report.pruned
                               if pc.reason.startswith("census failed")],
             "pipelines": {str(pc.config): [pc.predicted_step_s,
                                            pc.predicted_mfu]
                           for pc in ranked if pc.config.pp > 1}}
        out[f"n{n}"] = r
        log(f"plan 15(a): Llama-3-8B, 32 layers, bf16, recompute full, "
            f"batch {PLAN_BATCH} x {PLAN_SEQ} on {n} cards ({spec.kind}, "
            f"link {spec.link_bw:.4g} B/s): {secs:.1f} s, {len(ranked)} "
            f"ranked, {len(mem_pruned)} pruned by the memory model "
            f"(capacity {cap} bytes), chosen {r['chosen']} (predicted "
            f"step, a prediction, not a measurement); the pipelines' "
            f"predicted step (s) and MFU {r['pipelines']}\n"
            f"{report.table(top=5)}")
        if (not ranked or r["over_capacity"] or r["no_census"]
                or r["census_failed"]):
            fails.append(f"plan n{n}")
    after = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
             else 0)
    out["card_memory_before_after"] = [before, after]
    if after != before:
        fails.append("the pricing allocated card memory")
    return out, fails


def plan_leg(torch, pt, dev, cfg, batch, plan_):
    """15(b): phase 7's model (seed 10, AdamW 1e-4, weight decay 0.01,
    clip 1.0) through ``Trainer.apply_plan(plan_)``, 2 + 4 steps, launch
    counts of the timed steps. Returns (numbers, final parameters)."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.parallel.api import full_state_dict
    from paddle_tpu_torch.trainer import Trainer
    model = LlamaForCausalLM(cfg, device=dev,
                             generator=pt.generator(10, dev))
    trainer = Trainer(model, AdamW(learning_rate=1e-4, parameters=model,
                                   weight_decay=0.01,
                                   grad_clip=ClipGradByGlobalNorm(1.0)))
    hm = trainer.apply_plan(plan_, devices=dev.type)
    with hm:
        warm = trainer.fit(iter([batch] * MESH_STEPS[0]), MESH_STEPS[0],
                           log_every=1)
        sync(torch, dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        hist = trainer.fit(iter([batch] * MESH_STEPS[1]), MESH_STEPS[1],
                           log_every=1)
        sync(torch, dev)
        launches = dict(_build.LAUNCHES)
        params = full_state_dict(model)
    times = [m.step_time_s for m in hist]
    info = {"losses": [m.loss for m in warm + hist], "step_times_s": times,
            "median_step_s": statistics.median(times),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
            "launches": launches, "mesh_shape": hm.shape}
    del trainer, model
    empty_cache(torch, dev)
    return info, params


def plan_world1(torch, pt, dev, make_cfg, b, s):
    """15(b) (see the module docstring)."""
    import torch.distributed as dist
    from paddle_tpu_torch.distributed.auto_parallel import (
        ParallelConfig, estimate_hbm, plan)
    from paddle_tpu_torch.parallel.mesh import init_parallel_env
    cfg = make_cfg(num_hidden_layers=4, dtype="bfloat16")
    batch = train_batch(torch, cfg.vocab_size, b, s, dev, 10)
    plain, want = mesh_leg(torch, pt, dev, cfg, batch)
    report = plan(cfg, n_devices=1, global_batch=b, seq_len=s,
                  drift="ignore")
    chosen = report.chosen
    init_parallel_env(backend="nccl" if dev.type == "cuda" else "gloo",
                      init_method=f"tcp://localhost:{free_port()}",
                      world_size=1, rank=0, device=dev.type)
    try:
        mine, got = plan_leg(torch, pt, dev, cfg, batch, chosen.plan)
    finally:
        dist.destroy_process_group()
    diff = sorted(n for n in want if not torch.equal(got[n], want[n]))
    est = estimate_hbm(cfg, ParallelConfig.parse(str(chosen.config)),
                       global_batch=b, seq_len=s)
    peak = mine["peak_memory_bytes"]
    out = {"plain": plain, "apply_plan": mine,
           "chosen": str(chosen.config),
           "predicted_step_s": chosen.predicted_step_s,
           "estimate_hbm_bytes": est.total_bytes,
           "estimate_over_measured_peak": (est.total_bytes / peak
                                           if peak else None),
           "params_differing": diff,
           "losses_equal": plain["losses"] == mine["losses"],
           "card": RESULTS.get("card")}
    out["ok"] = out["losses_equal"] and not diff and all(
        mine["launches"].get(k, 0) > 0 for k in TRAINING_KERNELS)
    log(f"plan 15(b): apply_plan({chosen.config}) at world size 1 on phase "
        f"7's model ({MESH_STEPS[0]} + {MESH_STEPS[1]} steps of {b} x {s}, "
        f"4 layers, bf16): losses equal to the plain path's: "
        f"{out['losses_equal']} ({mine['losses']}); parameters differing: "
        f"{diff or 'none'}; median step {mine['median_step_s']:.4f} s "
        f"(plain {plain['median_step_s']:.4f} s; predicted "
        f"{chosen.predicted_step_s:.4f} s, a prediction); peak memory "
        f"{peak} bytes, estimate_hbm {est.total_bytes:.0f} bytes, ratio "
        f"{out['estimate_over_measured_peak']}; launches "
        f"{mine['launches']}; {card_line()}")
    del want, got
    empty_cache(torch, dev)
    return out


def expected_slice(torch, full, spec, blocks, axes, coords):
    """``shard_layer``'s cut of ``full`` for the rank at ``coords``:
    ``tp_slice`` over the tensor dimension, then FSDP2's row chunk."""
    from paddle_tpu_torch.parallel.api import tp_slice
    tp_dim = next((d for d, e in enumerate(spec or ())
                   if e == "tp" or (isinstance(e, (tuple, list))
                                    and "tp" in e)), None)
    t = full
    if tp_dim is not None and axes.get("tp", 1) > 1:
        t = tp_slice(t, tp_dim, blocks, axes["tp"], coords.get("tp", 0))
    f = axes.get("fsdp", 1)
    if f > 1:
        parts = t.chunk(f)
        i = coords.get("fsdp", 0)
        t = parts[i] if i < len(parts) else t[:0]
    return t


def reshard_reads(torch, pt, dev, make_cfg):
    """15(c) (see the module docstring)."""
    import shutil
    import torch.distributed as dist
    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.distributed.auto_parallel import (ParallelConfig,
                                                            plan_for_config)
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.models.llama import sharding_annotations
    from paddle_tpu_torch.parallel.mesh import init_parallel_env
    from paddle_tpu_torch.resilience.reshard import load_resharded
    cfg = make_cfg(num_hidden_layers=1, dtype="bfloat16")
    root = os.path.join(ROOT_OUT, "plan_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    model = LlamaForCausalLM(cfg, device=dev,
                             generator=pt.generator(10, dev))
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    ann = sharding_annotations(cfg)
    src = plan_for_config(cfg, ParallelConfig())
    init_parallel_env(backend="nccl" if dev.type == "cuda" else "gloo",
                      init_method=f"tcp://localhost:{free_port()}",
                      world_size=1, rank=0, device=dev.type)
    try:
        with src.apply(model, devices=dev.type):
            t0 = time.perf_counter()
            checkpoint.save_state_dict(
                {"params": dict(model.named_parameters())}, root,
                layout=model)
            save_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    nbytes = sum(t.numel() * t.element_size() for t in full.values())
    like = {"params": {n: t for n, t in full.items()}}
    out = {"save_s": save_s, "bytes": nbytes, "targets": {}}
    fails = []
    for text in RESHARD_TARGETS:
        tgt = plan_for_config(cfg, ParallelConfig.parse(text))
        axes = tgt.axes
        read_s, read_bytes, bad = 0.0, 0, []
        for r in range(tgt.size):
            coords = checkpoint.mesh_coords(axes, r)
            sync(torch, dev)
            t0 = time.perf_counter()
            got = load_resharded(root, like, tgt, coords=coords)
            sync(torch, dev)
            read_s += time.perf_counter() - t0
            for n, t in got["params"].items():
                read_bytes += t.numel() * t.element_size()
                want = expected_slice(torch, full[n], tgt.param_specs[n],
                                      ann[n][1], axes, coords)
                if t.device != full[n].device or not torch.equal(t, want):
                    bad.append((r, n))
            del got
        out["targets"][text] = {"ranks": tgt.size, "read_s": read_s,
                                "bytes": read_bytes,
                                "GB_per_s": read_bytes / read_s / 1e9,
                                "differing": bad[:8]}
        log(f"plan 15(c): {text}: {tgt.size} ranks' slices of the "
            f"world-size-1 checkpoint ({nbytes / 1e9:.3f} GB saved in "
            f"{save_s:.2f} s) read onto {dev} in {read_s:.2f} s "
            f"({read_bytes / read_s / 1e9:.3f} GB/s, warm page cache); "
            f"slices differing from shard_layer's cut: {bad[:8] or 'none'}; "
            f"{card_line()}")
        if bad:
            fails.append(f"reshard {text}")
    shutil.rmtree(root, ignore_errors=True)
    del model, full, like
    empty_cache(torch, dev)
    return out, fails


# 15(a)'s calibration leg: the rank-order model of tools/elastic_check.py
# (Llama-3-8B widths, 2 layers, 4 x 4096 tokens, dp4 and tp4 on 4 cards)
# and the steps tools/elastic_check.py's rank-order pod measured for it on
# four H100 80GB HBM3 at 700 W (PERF.md)
CALIBRATED_LAYERS = 2
CALIBRATED_BATCH = (4, 4096)
CALIBRATED_MEASURED_MS = {"dp4": 135.0, "tp4": 77.0}


def plan_calibrated(torch, dev, make_cfg):
    """15(a), measured floors: ``tools/op_cost_probe --calibrate`` on this
    card into ``chiprun_out/op_cost_db.json``, then dp4 and tp4 of the
    rank-order model priced from one census each, without an OpCostDB
    and with the calibrated one; both predictions printed beside the
    steps measured for it on four cards (CALIBRATED_MEASURED_MS). Returns
    (results, failures)."""
    from paddle_tpu_torch.distributed.auto_parallel import ParallelConfig
    from paddle_tpu_torch.distributed.auto_parallel.planner import (
        census_configs, price_config)
    from paddle_tpu_torch.observability.costs import OpCostDB, device_spec
    from paddle_tpu_torch.observability.costs.device_db import H100_LINK_BW
    from paddle_tpu_torch.tools import op_cost_probe
    os.makedirs(ROOT_OUT, exist_ok=True)
    path = os.path.join(ROOT_OUT, "op_cost_db.json")
    if os.path.exists(path):
        os.remove(path)
    t0 = time.perf_counter()
    probe = op_cost_probe.main(["--calibrate", "--db", path,
                                "--device", dev.type])
    probe_s = time.perf_counter() - t0
    cfg = make_cfg(num_hidden_layers=CALIBRATED_LAYERS, dtype="bfloat16")
    spec = device_spec(link_bw=H100_LINK_BW)
    configs = [ParallelConfig(dp=4), ParallelConfig(tp=4)]
    b, seq = CALIBRATED_BATCH
    t1 = time.perf_counter()
    records = census_configs(cfg, configs, 4, global_batch=b, seq_len=seq)
    census_s = time.perf_counter() - t1
    dbs = {"analytical": OpCostDB(user_path=os.path.join(
               ROOT_OUT, "op_cost_db_absent.json")),
           "calibrated": OpCostDB(user_path=path)}
    out = {"probe": probe, "probe_s": probe_s, "census_s": census_s,
           "configs": {}}
    fails = []
    for c in configs:
        name = "tp4" if c.tp == 4 else "dp4"
        row = {"measured_ms_four_cards": CALIBRATED_MEASURED_MS[name]}
        for label, db in dbs.items():
            pc = price_config(c, cfg, global_batch=b, seq_len=seq,
                              spec=spec, db=db, check_memory=False,
                              record=records[str(c)])
            if not pc.feasible or pc.graph is None:
                fails.append(f"15(a) calibrated: {c} {label}: {pc.reason}")
                continue
            row[label] = {"predicted_ms": pc.predicted_step_s * 1e3,
                          "dispatch_ms": pc.graph.dispatch_s * 1e3,
                          "dot_adjust_ms": pc.graph.dot_adjust_s * 1e3}
        out["configs"][name] = row
    floor = probe["graphs"]["train_step_k1"]["dispatch_floor_s"]
    log(f"plan 15(a) calibrated: op_cost_probe --calibrate on "
        f"{probe['device_kind']} in {probe_s:.1f} s (train_step_k1 "
        f"{probe['graphs']['train_step_k1']['t_s'] * 1e3:.3f} ms, dispatch "
        f"floor {floor * 1e3:.3f} ms, {len(probe['recorded'])} keys); "
        f"Llama-3-8B widths, {CALIBRATED_LAYERS} layers, bf16, {b} x {seq} "
        f"tokens on 4 cards, predicted step without / with the OpCostDB "
        f"against the measured on four cards: " + "; ".join(
            f"{n} {r.get('analytical', {}).get('predicted_ms', 0):.3f} / "
            f"{r.get('calibrated', {}).get('predicted_ms', 0):.3f} ms vs "
            f"{r['measured_ms_four_cards']:.0f} ms" for n, r in
            out["configs"].items()) + f" {card_line()}")
    if not probe["recorded"][0].startswith("graph:train_step_k1|"):
        fails.append(f"15(a) calibrated: the probe recorded "
                     f"{probe['recorded']}")
    return out, fails


def phase_plan(torch, pt, dev, make_cfg, b=2, s=4096):
    """Phase 15 (see the module docstring). Returns (b)'s launches."""
    out = RESULTS.setdefault("plan", {})
    t0 = time.perf_counter()
    out["planner"], fails = plan_meshes(torch, dev, make_cfg)
    out["calibrated"], more = plan_calibrated(torch, dev, make_cfg)
    fails += more
    mark("15a planner")
    out["world1"] = plan_world1(torch, pt, dev, make_cfg, b, s)
    if not out["world1"]["ok"]:
        fails.append("apply_plan")
    mark("15b apply_plan")
    out["reshard"], more = reshard_reads(torch, pt, dev, make_cfg)
    fails += more
    out["seconds"] = time.perf_counter() - t0
    if fails:
        raise SystemExit(f"phase 15 checks failed: {fails}")
    return out["world1"]["apply_plan"]["launches"]


# -- 16: the native host runtime -------------------------------------------

NATIVE_BATCHES = 512         # phase 7's batches the shm loader carries
NATIVE_WORKERS = 2
NATIVE_WAIT_S = 120.0        # the child's bounded waits


class TokenRows:
    """Phase 7's token batches as a map dataset: sample i is a row of
    4096 tokens and its next-token labels (numpy, seed 10 + i, phase 7's
    vocabulary), so batches of 2 are phase 7's shape."""

    def __init__(self, n, vocab, s=4096):
        self.n, self.vocab, self.s = n, vocab, s

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        ids = np.random.RandomState(10 + i).randint(0, self.vocab,
                                                    (self.s + 1,))
        return {"input_ids": ids[:-1], "labels": ids[1:]}


def native_child(port, ring_name):
    """The other process of 16's round trip: read the parent's key from
    the TCPStore, answer through it, and push a message into the
    parent's ShmRing."""
    from paddle_tpu_torch import native
    store = native.TCPStore(port=port, timeout=NATIVE_WAIT_S)
    ring = native.ShmRing.open(ring_name)
    try:
        v = store.get("ping", timeout=NATIVE_WAIT_S)
        store.set("pong", v[::-1])
        ring.push(v + b"|ring", timeout=NATIVE_WAIT_S)
    finally:
        ring._h = None        # an opener never unlinks; the parent owns it
        store.close()


def phase_native(torch, pt, dev, make_cfg):
    """Phase 16 (see the module docstring). Returns (results, failures)."""
    import multiprocessing as mp
    from paddle_tpu_torch import native
    from paddle_tpu_torch.io import DataLoader
    out, fails = {}, []
    t0 = time.perf_counter()
    out["available"] = native.is_available()
    out["library"] = str(native.library_path())
    out["build_s"] = time.perf_counter() - t0
    if not out["available"]:
        raise SystemExit(f"the native library did not build: "
                         f"{native.build_error()}")
    vocab = make_cfg().vocab_size
    data = TokenRows(2 * NATIVE_BATCHES, vocab)
    loaders = {"main": DataLoader(data, batch_size=2),
               "shm_ring": DataLoader(data, batch_size=2,
                                      num_workers=NATIVE_WORKERS,
                                      use_shared_memory=True)}
    got = {}
    for name, dl in loaders.items():
        # the rate runs from the first batch's arrival: before it, the
        # ring's workers start (spawned, each importing torch)
        t = time.perf_counter()
        it = iter(dl)
        got[name] = [next(it)]
        t1 = time.perf_counter()
        got[name] += list(it)
        secs = time.perf_counter() - t1
        out[name] = {"batches": len(got[name]), "first_batch_s": t1 - t,
                     "seconds_after_first": secs,
                     "batches_per_s": (len(got[name]) - 1) / secs,
                     "transport": dict(dl.transport)}
    equal = len(got["main"]) == len(got["shm_ring"]) == NATIVE_BATCHES \
        and all(torch.equal(a[k], b[k]) for a, b in zip(got["main"],
                                                        got["shm_ring"])
                for k in a)
    ring_ran = out["shm_ring"]["transport"]["shm_ring"] == NATIVE_BATCHES
    out["batches_equal"], out["ring_ran"] = equal, ring_ran
    if not (equal and ring_ran):
        fails.append(f"16: shm batches equal {equal}, the ring ran "
                     f"{out['shm_ring']['transport']}")
    # two processes: the store and the ring, one round trip each
    store = native.TCPStore(is_master=True, timeout=NATIVE_WAIT_S)
    ring = native.ShmRing(capacity=1 << 20)
    proc = mp.get_context("spawn").Process(
        target=native_child, args=(store.port, ring.name))
    try:
        t = time.perf_counter()
        proc.start()
        store.set("ping", b"chip_smoke")
        pong = store.get("pong", timeout=NATIVE_WAIT_S)
        msg = ring.pop(timeout=NATIVE_WAIT_S)
        rt = time.perf_counter() - t
        proc.join(timeout=NATIVE_WAIT_S)
    finally:
        if proc.is_alive():
            proc.kill()
        ring.destroy()
        store.close()
    out["round_trip"] = {"store": pong == b"ekoms_pihc",
                         "ring": msg == b"chip_smoke|ring",
                         "child_exit": proc.exitcode,
                         "seconds_with_spawn": rt}
    if not (out["round_trip"]["store"] and out["round_trip"]["ring"]
            and proc.exitcode == 0):
        fails.append(f"16: the two-process round trip {out['round_trip']}")
    pool = native.HostPool()
    arrs = [pool.alloc((2, 4096), np.int64) for _ in range(4)]
    peak = pool.stats()
    for a in arrs:
        pool.free(a)
    again = pool.alloc((2, 4096), np.int64)
    reused = pool.stats()
    pool.free(again)
    pool.trim()
    out["host_pool"] = {"peak": peak, "after_reuse": reused,
                        "after_trim": pool.stats()}
    if reused["reserved"] != peak["reserved"]:
        fails.append(f"16: the host pool did not reuse {out['host_pool']}")
    out["seconds"] = time.perf_counter() - t0
    log(f"native (16): {native.version()} built from "
        f"paddle_tpu_torch/csrc/pt_native.cc ({out['build_s']:.2f} s to "
        f"load); {NATIVE_BATCHES} of phase 7's batches (2 x 4096) through "
        f"DataLoader(num_workers={NATIVE_WORKERS}, use_shared_memory=True):"
        f" equal to num_workers=0 {equal}, transport "
        f"{out['shm_ring']['transport']}, {out['shm_ring']['batches_per_s']:.1f}"
        f" batches/s after the first batch (which took "
        f"{out['shm_ring']['first_batch_s']:.2f} s: the workers' spawn) "
        f"against {out['main']['batches_per_s']:.1f} in the main process; the "
        f"two-process TCPStore and ShmRing round trip {out['round_trip']};"
        f" HostPool {out['host_pool']}; {out['seconds']:.1f} s")
    return out, fails


# -- phase 17: graph contracts ------------------------------------------------

#: the kernels the registry's single-process graphs run on the card (the
#: grouped matmul's only graph, train_step_moe_ep, needs four cards)
GRAPH_KERNELS = TRAINING_KERNELS + ("paged_decode", "paged_decode_int8",
                                    "int8_matmul")
#: 17(b): no buffer of the vocabulary's width may span this many rows
LOGITS_ROWS = 8192
#: 17(c): the trace-overhead legs over replicas of 5d's engine settings
OVERHEAD_LEGS = dict(rounds=3, n_requests=6, max_new=8)
#: phase 17's results and failures, filled by the legs inside phases 5
#: and 7 (on the models they build) and by phase 17 itself
GRAPHS: dict = {"fails": []}
#: 5e's completed request traces (the window runs traced)
FRONTDOOR_TRACES: list = []


def sync_error(torch, dev, fn):
    """Run ``fn`` under torch.cuda.set_sync_debug_mode("error"); returns
    None, or the error a host sync raised."""
    sync(torch, dev)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return None
    except RuntimeError as e:
        return str(e)[:500]
    finally:
        torch.cuda.set_sync_debug_mode(mode)
        sync(torch, dev)


def full_width_census(torch, dev, label, call, inputs, vocab, modes=()):
    """17(b): the census of one ``call`` at full width (named
    ``inputs``), taken under set_sync_debug_mode("error"); fails (into
    GRAPHS["fails"]) on a buffer of the vocabulary's width over
    LOGITS_ROWS rows, a host sync (the census's or the card's), or a
    named input not updated in place."""
    import contextlib
    from paddle_tpu_torch import analysis as A
    from paddle_tpu_torch.analysis.collectives import StepCensus
    box = {}

    def run():
        with contextlib.ExitStack() as st:
            for m in modes:
                st.enter_context(m())
            box["c"] = st.enter_context(StepCensus(inputs=inputs))
            call()
    t0 = time.perf_counter()
    err = sync_error(torch, dev, run)
    secs = time.perf_counter() - t0
    c = box["c"]
    wide = [f"{l} <- {o.name}" for o in c.ops + c.allocs for l in o.outputs
            if l.dims and l.dims[-1] == vocab
            and math.prod(l.dims[:-1]) >= LOGITS_ROWS]
    don = A.donation_report(c)
    aliased = {a["label"] for a in don["aliased"]}
    kept = sorted(k for k in c.inputs if k not in aliased)
    mat = A.materialization_report(c)
    out = {"ops": len(c.ops), "inputs": len(c.inputs),
           "in_place": len(aliased), "donated_bytes": don["donated_bytes"],
           "not_in_place": kept[:8], "host_syncs": [
               h.describe() for h in c.host_syncs], "sync_error": err,
           "wide_buffers": wide[:8], "largest": mat["largest_buffers"][:3],
           "seconds": secs}
    GRAPHS[label] = out
    log(f"graph contracts 17(b) {label}: census of {len(c.ops)} ops in "
        f"{secs:.2f} s under set_sync_debug_mode('error') (error: {err}); "
        f"host syncs {len(c.host_syncs)}; buffers [>= {LOGITS_ROWS}, "
        f"{vocab}] {len(wide)}; {len(aliased)} of {len(c.inputs)} named "
        f"inputs in place ({don['donated_bytes']} bytes); largest "
        f"{mat['largest_buffers'][:2]} {card_line()}")
    if err or c.host_syncs or wide or kept or not c.inputs:
        GRAPHS["fails"].append(f"17(b) {label}: {out}")
    return out


def decode_census(torch, dev, model):
    """17(b), serving: one decode block of phase 5's 32-layer engine
    (SERVE_KW, 8 requests admitted and decoding) under the census:
    every KV pool and scheduler tensor written in place, no host sync,
    no [>= 8192, V] buffer."""
    from paddle_tpu_torch.analysis.graphs import engine_inputs
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.ops.attention import force_decode_impl
    eng = ContinuousBatchingEngine(model, **SERVE_KW)
    prompts, _ = serving_traffic(model.cfg.vocab_size)
    for p in prompts[:SERVE_KW["max_batch"]]:
        eng.submit(p, max_new_tokens=SERVE_NEW * 4)
    for _ in range(4):
        eng.step()
    with torch.inference_mode():
        eng._tables_dev = eng._to_device(eng.tables)
    full_width_census(
        torch, dev, "decode_8b",
        lambda: eng._decode_block(SERVE_KW["decode_block"], False),
        lambda: engine_inputs(eng), model.cfg.vocab_size,
        modes=(torch.inference_mode, lambda: force_decode_impl("paged")))
    del eng
    empty_cache(torch, dev)


def critical_path_leg(torch, dev, model):
    """17(c): 5e's stitched front-door traces attributed hop by hop
    (``analysis.critical_path``: the per-hop TTFT share at p50, and each
    request's share on named hops, which must be at least
    ``load_test.NAMED_FLOOR``, 0.95), then
    ``load_test.trace_overhead_legs`` over two replicas of 5d's engine
    settings (6 requests, 8 new tokens, 3 rounds)."""
    from paddle_tpu_torch.analysis import critical_path as cp
    from paddle_tpu_torch.tools.load_test import (NAMED_FLOOR,
                                                  attributed_shares,
                                                  trace_overhead_legs)
    traces = list(FRONTDOOR_TRACES)
    agg = cp.aggregate(traces) if traces else {}
    named = attributed_shares(traces)
    low = {t: f for t, f in named.items() if f < NAMED_FLOOR}
    t0 = time.perf_counter()
    legs = trace_overhead_legs(model, **OVERHEAD_LEGS, **SERVE_KW)
    out = {"traces": len(traces), "with_ttft": len(named),
           "p50_frac": {h: r["p50_frac"] for h, r in agg.items()},
           "p50_ms": {h: r["p50_s"] * 1e3 for h, r in agg.items()},
           "named_min": min(named.values()) if named else None,
           "below_floor": low, "overhead": legs,
           "overhead_s": time.perf_counter() - t0}
    GRAPHS["critical_path"] = out
    log("graph contracts 17(c): 5e's traces, per-hop TTFT (p50 share, p50 "
        "ms): " + ", ".join(f"{h} {r['p50_frac']:.3f} / "
                            f"{r['p50_s'] * 1e3:.1f}" for h, r in sorted(
                                agg.items(), key=lambda kv:
                                -kv[1]["p50_frac"]))
        + f"; {len(named)} of {len(traces)} traces with a TTFT, least share "
        f"on named hops {out['named_min']}; trace overhead (6 requests, 8 "
        f"tokens, min of 3): on {legs['wall_on_s']:.4f} s, off "
        f"{legs['wall_off_s']:.4f} s, ratio {legs['ratio']:.4f} "
        f"{card_line()}")
    sent = RESULTS.get("frontdoor", {}).get("requests_sent", 1)
    if len(named) < sent or low:
        GRAPHS["fails"].append(f"17(c): {len(named)} traces with a TTFT "
                               f"for {sent} requests, below the floor "
                               f"{low}")


#: 17(a), the card's micro graphs against the same graphs built on the
#: CPU from the same seeds, relative L2 a tensor: the AdamW moments (a
#: sum and a sum of squares of the gradients, phase 6's fp32 gradient
#: tolerance) and the parameters and masters after AdamW, whose update
#: divides each moment by the root of the other: where a gradient lies
#: within its rounding of zero the update's sign is the rounding's, and
#: such an element moves up to 2 lr apart on the two sides. Every other
#: float output is held elementwise at TOL["float32"], int8 codes to one
#: step (a value on a rounding boundary) and integers exactly.
GRAPH_MOMENT_TOL = 1e-4
GRAPH_PARAM_TOL = 1e-3


def graph_output_errors(torch, name, card, cpu):
    """(worst reading a check, failures) of one micro graph's outputs on
    the card against the same graph's on the CPU (``BuiltGraph.outputs``:
    the censused call's returns and its named inputs after it)."""
    worst, fails = {}, []
    for key, want in cpu.items():
        got = card.get(key)
        if got is None or got.shape != want.shape or got.dtype != want.dtype:
            seen = None if got is None else (tuple(got.shape), got.dtype)
            fails.append(f"{name} {key}: card {seen}, cpu "
                         f"{(tuple(want.shape), want.dtype)}")
            continue
        if want.dtype == torch.int8:
            kind, err = "int8 codes", float((got.int() - want.int()).abs()
                                            .max()) if want.numel() else 0.0
            ok = err <= 1
        elif not want.is_floating_point():
            kind, err = "exact", float((got != want).sum())
            ok = err == 0
        elif key.startswith(("params[", "opt_state['master']",
                             "opt_state['slots']")):
            moment = key.startswith("opt_state['slots']")
            kind = "moments L2" if moment else "parameters L2"
            err = float((got.double() - want.double()).norm()
                        / want.double().norm().clamp_min(1e-30))
            ok = err <= (GRAPH_MOMENT_TOL if moment else GRAPH_PARAM_TOL)
        else:
            kind = "elementwise"
            err, _, ok = compare(torch, got, want, "float32")
        if kind not in worst or err > worst[kind][0]:
            worst[kind] = (err, key)
        if not ok or not bool(torch.isfinite(got.float()).all()):
            fails.append(f"{name} {key}: {kind} {err:.3e}")
    return worst, fails


def micro_kernel_cases(torch, dev):
    """17(a), each kernel the micro graphs launch held against its plain
    version at their shapes, fp32 (the micro graphs' dtype): hidden 128
    over 4 query and 2 key/value heads of 32 (rows of 2 x 20 tokens and
    of a 2-slot decode), vocabulary 320 (and the fused CE graph's 64 x
    32), pages of 8 over 8 a slot, the int8 products of a 2-row decode.
    Recorded as "micro_*" kernel cases; returns the ones that failed."""
    from paddle_tpu_torch.nn.quantized_linear import weight_quantize
    from paddle_tpu_torch.ops import attention as attn_ops
    from paddle_tpu_torch.ops import norm as norm_ops
    from paddle_tpu_torch.ops import quant as quant_ops
    from paddle_tpu_torch.ops import rope as rope_ops
    from paddle_tpu_torch.ops import vocab_ce
    from paddle_tpu_torch.ops.kernels import (flash_attention, fused_norm,
                                              fused_rope, paged_attention)
    from paddle_tpu_torch.ops.kernels import fused_vocab_ce as kce
    from paddle_tpu_torch.ops.kernels import int8_matmul as kmm
    g = torch.Generator(device=dev)
    g.manual_seed(1717)
    f32, i32 = "float32", torch.int32
    first = len(FAILED_CASES)
    D, H, HKV, HD, V, eps = 128, 4, 2, 32, 320, 1e-5

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def both(pairs):
        errs = [compare(torch, a, b, f32) for a, b in pairs]
        return (max(e[0] for e in errs), max(e[1] for e in errs),
                all(e[2] for e in errs))
    for case, rows in (("micro_train_40", 40), ("micro_decode_2", 2)):
        x, w = randn(rows, D), 1 + 0.1 * randn(D)
        record("rms_norm", case, f32, norm_err(torch, fused_norm.rms_norm_fwd(
            x, w, eps, return_rstd=True), norm_ops._rms_norm_fwd_plain(
                x, w, eps), f32))
    x, dy, w = randn(40, D), randn(40, D), 1 + 0.1 * randn(D)
    _, rstd = fused_norm.rms_norm_fwd(x, w, eps, return_rstd=True)
    record("rms_norm_bwd", "micro_train_40", f32, both(zip(
        fused_norm.rms_norm_bwd(x, w, rstd, dy),
        norm_ops._rms_norm_bwd_plain(x, w, rstd, dy))))
    cos, sin = rope_ops.rope_freqs(HD, 128, 10000.0, device=dev)
    for case, (b, s), pos in (
            ("micro_train_2x20", (2, 20), None),
            ("micro_decode_2", (2, 1),
             torch.tensor([[5], [19]], device=dev))):
        qkv = randn(b, s, (H + 2 * HKV) * HD)
        q = qkv[..., :H * HD].view(b, s, H, HD)
        k = qkv[..., H * HD:(H + HKV) * HD].view(b, s, HKV, HD)
        for sn, label in ((sin, ""), (-sin, "_bwd")):
            record("fused_rope", case + label, f32, both(zip(
                fused_rope.fused_rope(q, k, cos, sn, pos),
                rope_ops._rope_plain(q, k, cos, sn, pos))))
    q, k, v, dout = randn(2, 20, H, HD), randn(2, 20, HKV, HD), \
        randn(2, 20, HKV, HD), randn(2, 20, H, HD)
    args = (True, HD ** -0.5, None, None, 0.0, 2024)
    out, lse = flash_attention.flash_fwd(q, k, v, *args)
    want_out, want_lse = attn_ops._flash_fwd_plain(q, k, v, *args)
    record("flash_fwd", "micro_train_2x20", f32, flash_compare(
        torch, [(out, want_out), (lse, want_lse)], f32))
    delta = (want_out * dout).sum(-1).transpose(1, 2).contiguous()
    record("flash_bwd", "micro_train_2x20", f32, flash_compare(
        torch, list(zip(flash_attention.flash_bwd(q, k, v, dout, want_lse,
                                                  delta, *args),
                        attn_ops._flash_bwd_plain(q, k, v, dout, want_lse,
                                                  delta, *args))), f32))
    for case, (N, Hd) in (("micro_train_40", (40, D)),
                          ("micro_fused_ce_64", (64, 32))):
        h, w = randn(N, Hd), 0.1 * randn(Hd, V)
        labels = torch.randint(0, V, (N,), generator=g, device=dev).to(i32)
        labels[::7] = -1                              # ignored rows
        g_lse, g_tgt = randn(N), randn(N)
        wl, wt = vocab_ce._fwd_plain(h, w, labels)
        record("vocab_ce_fwd", case, f32, both(zip(
            kce.vocab_ce_fwd(h, w, labels), (wl, wt))))
        dlog = torch.empty((N, V), device=dev)
        kce.vocab_ce_dlog(h, w, labels, wl, g_lse, g_tgt, 0, V, dlog)
        record("vocab_ce_dlog", case, f32, compare(
            torch, dlog, vocab_ce._dlog_plain(h, w, labels.long()[:, None],
                                              wl, g_lse, g_tgt, 0, V)[0],
            f32))
        dh, dw = kce.vocab_ce_bwd(h, w, labels, wl, g_lse, g_tgt)
        wdh, wdw = vocab_ce._bwd_plain(h, w, labels, wl, g_lse, g_tgt)
        record("vocab_ce_dh", case, f32, compare(torch, dh, wdh, f32))
        record("vocab_ce_dw", case, f32, compare(torch, dw, wdw, f32))
    page, mp, B = 8, 8, 2
    num_pages = B * mp + 1
    qd = randn(B, H, HD)
    tables = (torch.randperm(num_pages - 1, generator=g, device=dev)
              + 1).view(B, mp).to(i32).contiguous()
    lens = torch.tensor([19, 4], device=dev)
    kp, vp = randn(HKV, num_pages, page, HD), randn(HKV, num_pages, page, HD)
    record("paged_decode", "micro_decode_2", f32, flash_compare(torch, [(
        paged_attention.paged_decode(qd, kp, vp, tables, lens),
        attn_ops.paged_decode_plain(qd, kp, vp, tables, lens))], f32))
    kq, ks = quant_pages(torch, g, dev, HKV, num_pages, page, HD)
    vq, vs = quant_pages(torch, g, dev, HKV, num_pages, page, HD)
    sc = dict(k_scales=ks, v_scales=vs)
    record("paged_decode_int8", "micro_decode_2", f32, flash_compare(
        torch, [(paged_attention.paged_decode(qd, kq, vq, tables, lens, **sc),
                 attn_ops.paged_decode_plain(qd, kq, vq, tables, lens,
                                             **sc))], f32))
    for proj, (n, kk) in {"qkv": ((H + 2 * HKV) * HD, D), "o": (D, H * HD),
                          "gate_up": (384, D), "down": (D, 192),
                          "lm_head": (V, D)}.items():
        wq, scale = weight_quantize(0.02 * randn(kk, n))
        xm = randn(2, kk)
        record("int8_matmul", f"micro_decode_{proj}", f32, int8_compare(
            torch, kmm.int8_matmul(xm, wq, scale),
            quant_ops.weight_only_plain(xm, wq, scale), f32))
    sync(torch, dev)
    return FAILED_CASES[first:]


def phase_graph_contracts(torch, dev):
    """Phase 17(a): every single-process graph of ``analysis.graphs`` on
    the card at the micro size, with the kernels, checked against the
    same budget file as the CPU (``graph_lint.check``); each graph with
    0 host transfers runs once more under set_sync_debug_mode("error").
    Launch counts reset just before and read just after (the
    "graph_contracts" path). Then every failure of 17(a)-(c) fails the
    run. Returns the launches."""
    from paddle_tpu_torch import analysis as A
    from paddle_tpu_torch.analysis.graphs import SHARDED
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.tools import graph_lint
    names = [n for n in A.graph_names() if n not in SHARDED]
    budgets = A.load_budgets(graph_lint.DEFAULT_BUDGETS)
    sync(torch, dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    viol, snaps, skipped, reps = graph_lint.check(names, dev, budgets,
                                                  log=lambda m: None)
    sync_free = {name: sync_error(torch, dev, g.call)
                 for name, (g, rep) in reps.items()
                 if rep.transfers["host_transfer_count"] == 0}
    launches = dict(_build.LAUNCHES)
    missing = [k for k in GRAPH_KERNELS if launches.get(k, 0) <= 0]
    # the same graphs built on the CPU (the plain versions) from the same
    # seeds: each censused call's outputs held against the card's
    outputs, out_fails = {}, []
    for name, (g, _) in reps.items():
        worst, fails = graph_output_errors(
            torch, name, g.outputs, A.build_graph(name, "cpu").outputs)
        outputs[name] = worst
        out_fails += fails
    case_fails = micro_kernel_cases(torch, dev)
    GRAPHS["micro"] = {"snapshots": snaps, "violations":
                       [v.render() for v in viol], "skipped": skipped,
                       "sync_free": sync_free, "launches": launches,
                       "outputs_vs_cpu": outputs,
                       "seconds": time.perf_counter() - t0}
    log(f"graph contracts 17(a): {len(reps)} graphs on the card against "
        f"the CPU's budgets: violations {len(viol)} "
        f"{[v.rule for v in viol]}; rerun under set_sync_debug_mode"
        f"('error'): {sync_free}; launches "
        f"{ {k: launches.get(k, 0) for k in GRAPH_KERNELS} }; outputs "
        f"against the CPU's (worst a check): {outputs}, failures "
        f"{out_fails}; micro kernel cases failed: {case_fails} "
        f"{card_line()}")
    GRAPHS["fails"] += ([v.render() for v in viol] + [
        f"17(a) {n}: a host sync: {e}" for n, e in sync_free.items() if e]
        + [f"17(a): kernels not launched: {missing}"] * bool(missing)
        + [f"17(a) outputs against the CPU: {f}" for f in out_fails]
        + [f"17(a) kernel case {c}" for c in case_fails])
    for need in ("train_8b", "decode_8b", "critical_path"):
        if need not in GRAPHS:
            GRAPHS["fails"].append(f"phase 17: the {need} leg did not run")
    RESULTS["graph_contracts"] = GRAPHS
    if GRAPHS["fails"]:
        os.makedirs(ROOT_OUT, exist_ok=True)
        with open(os.path.join(ROOT_OUT, "chip_smoke.json"), "w") as f:
            json.dump(RESULTS, f, indent=1, default=str)
        raise SystemExit(f"graph contracts failed: {GRAPHS['fails']}")
    return launches


def main() -> int:
    if "--client-process" in sys.argv:
        return client_process()
    if "--launch-worker" in sys.argv:
        return launch_worker()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.kernels import (_build, flash_attention,
                                              fused_norm, fused_rope,
                                              fused_vocab_ce, grouped_matmul,
                                              int8_matmul, paged_attention)
    t_start = _MARK[0] = time.perf_counter()
    # 1. the card
    card = pt.device_info()
    log(card)
    RESULTS["card"] = card
    # 2. build
    t0 = time.perf_counter()
    _build.lib()
    path = _build.library_path()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s -> {path}")
    RESULTS["build"] = {k: v for k, v in _build.BUILD_LOG.items()}
    mark("build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        phase_kernels(torch, pt)
        phase_quant_kernels(torch, pt)
    phase_train_kernels(torch, pt)
    phase_ce_kernels(torch, pt)
    with torch.inference_mode():
        phase_moe_kernels(torch, pt)
    mark("3 kernels")
    with torch.inference_mode():
        if "--parent" in sys.argv:
            phase_parent_turns(torch, sys.argv[sys.argv.index("--parent")
                                                + 1])
    if FAILED_CASES:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{FAILED_CASES}")
    from paddle_tpu_torch.models import LlamaConfig, MoEConfig
    dev = torch.device("cuda")
    phase_engine_equality(torch, pt, dev, LlamaConfig.llama3_8b)
    mark("4 engine equality")
    phase_quant_engine_equality(torch, pt, dev, LlamaConfig.llama3_8b)
    mark("4b quantized engine equality")
    phase_feature_equality(torch, pt, dev, LlamaConfig.llama3_8b)
    mark("4c feature equality")
    phase_fabric_equality(torch, pt, dev, LlamaConfig.llama3_8b)
    mark("4d fabric equality")
    phase_frontdoor_equality(torch, pt, dev, LlamaConfig.llama3_8b)
    mark("4e front-door equality")
    phase_generation_equality(torch, pt, dev, LlamaConfig.llama3_8b)
    mark("4f generation equality")
    serve_launches, quant_launches, feature_launches = phase_serving(
        torch, pt, dev, LlamaConfig.llama3_8b)
    ref = phase_train_equality(torch, pt, dev, LlamaConfig.llama3_8b,
                               "float32")
    phase_train_equality(torch, pt, dev, LlamaConfig.llama3_8b, "bfloat16")
    phase_recompute_equality(torch, pt, dev, LlamaConfig.llama3_8b, ref)
    mark("6 training equality")
    train_launches = phase_train(torch, pt, dev, LlamaConfig.llama3_8b)
    mark("7 training")
    phase_moe_sync(torch, pt, dev)
    for dtype in ("float32", "bfloat16"):
        phase_moe_equality(torch, pt, dev, MoEConfig.deepseek_moe_16b, dtype)
    moe_launches = phase_moe_train(torch, pt, dev, MoEConfig.deepseek_moe_16b)
    mark("8 MoE")
    runtime_launches = phase_trainer_runtime(torch, pt, dev,
                                             LlamaConfig.llama3_8b)
    mark("10 trainer runtime")
    optimizer_launches = phase_optimizers(torch, pt, dev,
                                          LlamaConfig.llama3_8b)
    mark("11 optimizers")
    mesh_launches = phase_mesh(torch, pt, dev, LlamaConfig.llama3_8b)
    mark("12 mesh")
    generation_mesh_launches = phase_generation_mesh(torch, pt, dev,
                                                     LlamaConfig.llama3_8b)
    mark("4f generation on a mesh")
    pipe_launches, ep_launches = phase_pipeline(torch, pt, dev,
                                                LlamaConfig.llama3_8b)
    mark("13 pipeline")
    launcher_launches, dm_launches, bench_launches = phase_launcher(
        torch, pt, dev, LlamaConfig.llama3_8b)
    mark("14 launcher")
    plan_launches = phase_plan(torch, pt, dev, LlamaConfig.llama3_8b)
    mark("15 plan")
    RESULTS["native"], native_fails = phase_native(torch, pt, dev,
                                                   LlamaConfig.llama3_8b)
    if native_fails:
        raise SystemExit(f"phase 16 checks failed: {native_fails}")
    mark("16 native")
    graph_launches = phase_graph_contracts(torch, dev)
    mark("17 graph contracts")
    mesh_paths = {"mesh": mesh_launches,
                  "ring_blocks": RESULTS["mesh"]["ring"]["causal"][
                      "launches"],
                  "vocab_shards": RESULTS["mesh"]["vocab_shards"][
                      "launches"],
                  "pipeline": pipe_launches, "ep_virtual": ep_launches,
                  "launcher": launcher_launches, "dist_model": dm_launches,
                  "bench_8b_layer": bench_launches,
                  "apply_plan": plan_launches,
                  "generation_mesh": generation_mesh_launches,
                  "graph_contracts": graph_launches}
    norm_rope_gaps()
    cases = RESULTS["kernel_cases"]

    def main_case(kernel, case):
        return next(c for c in cases if c["kernel"] == kernel
                    and c["case"] == case and c["dtype"] == "bfloat16")
    kernels = []
    for name, source, replaces, case in (
            ("rms_norm", fused_norm.SOURCE, fused_norm.REPLACES,
             "prefill_1024"),
            ("rms_norm_bwd", fused_norm.SOURCE, fused_norm.REPLACES_BWD,
             "train_8192"),
            ("fused_rope", fused_rope.SOURCE, fused_rope.REPLACES,
             "prefill_1024"),
            ("flash_fwd", flash_attention.SOURCE,
             flash_attention.REPLACES["flash_fwd"], "train_4096"),
            ("flash_bwd", flash_attention.SOURCE,
             flash_attention.REPLACES["flash_bwd"], "train_4096"),
            ("paged_decode", paged_attention.SOURCE,
             paged_attention.REPLACES, "ctx1024"),
            *((name, fused_vocab_ce.SOURCE, fused_vocab_ce.REPLACES[name],
               "train_chunk_8192" if name == "vocab_ce_dlog"
               else "train_8192") for name in CE_KERNELS),
            ("int8_matmul", int8_matmul.SOURCE, int8_matmul.REPLACES,
             "decode_gate_up"),
            ("paged_decode_int8", paged_attention.SOURCE,
             paged_attention.REPLACES, "ctx1024"),
            ("grouped_matmul", grouped_matmul.SOURCE,
             grouped_matmul.REPLACES, "gate_up_balanced"),
            ("grouped_matmul_dw", grouped_matmul.SOURCE,
             grouped_matmul.REPLACES_DW, "gate_up_balanced")):
        c = main_case(name, case)
        by_path = {"serving": serve_launches[name],
                   "training": train_launches[name],
                   "quantized_serving": quant_launches[name],
                   "moe_training": moe_launches[name],
                   "trainer_runtime": runtime_launches[name],
                   "optimizers": optimizer_launches.get(name, 0),
                   **{label: counts.get(name, 0)
                      for label, counts in feature_launches.items()},
                   **{label: counts.get(name, 0)
                      for label, counts in mesh_paths.items()}}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # launches on the main paths: the serving run, the timed
            # training steps, the quantized serving run, the timed MoE
            # training steps, phase 10's trainer runtime, phase 11's
            # eight optimizers' runs, phase 5c's
            # feature runs, 5d's fabric runs and 5e's front-door window,
            # 5f's generation calls (native and int8),
            # phase 12's mesh steps, virtual ring and vocabulary shards,
            # phase 13's 1F1B pipeline steps and virtual ep pass, phase
            # 14's launched worker, DistModel and bench_8b_layer runs,
            # phase 15's apply_plan steps, phase 17's micro graphs, and
            # each path's own count
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in cases
                               if x["kernel"] == name),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
    RESULTS["seconds"] = time.perf_counter() - t_start
    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RESULTS, f, indent=1, default=str)
    log(f"chip_smoke finished in {RESULTS['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
