"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (PATH, $CUDA_HOME or /usr/local/cuda) and the
repository checkout it sits in. Phases, each of which fails the run:

1. the card's name and power limit (nvidia-smi);
2. build every kernel of the serving, training, DLRM and dense-update
   paths from elasticdl_tpu_torch/csrc (flash_fwd.cu, flash_bwd.cu,
   paged_decode.cu, embedding_gather.cu, row_update.cu,
   optimizer_update.cu; one nvcc per source or part, all at once,
   flash_fwd.cu as seven parts and flash_bwd.cu as eleven, each linked into
   one library; the host tier's store, host_embedding.cc, with the host
   C++ compiler beside them), and print each flash_fwd and flash_bwd instance's
   registers, spills, stack frame and shared memory from ptxas's report
   (no instance may spill, no fp32 forward instance may have a stack
   frame); the fp32 forward and backward instances' SASS (cuobjdump)
   must hold no tensor-core product and no 16-bit or TF32 conversion;
3. kernel A (flash forward) against its plain PyTorch version at the
   prefill shapes, the bf16 kernel against the plain version that
   scales q in bf16 and rounds P to bf16 as it and the TPU kernel do
   (bf16_operands=True; so is every bf16 check of A below); then each
   of the bf16 kernel's 32 instances (d 64 and 128, causal or not,
   window, segments, pos_offset) at GQA 4/2, ragged l and, without a
   window, rectangular lq != lk, its lse also within
   FWD_ROUNDED_TOL_LSE and its out within FWD_ROUNDED_TOL_RMS of the
   rounded plain version and the unrounded one further away; then a
   probe of P's bf16 rounding (V = I); every fp32 check of A here and
   below holds out and lse within FWD_F32_TOL_REL of the plain version's
   largest value (lse over the rows that see a key; a row that sees
   none has lse +1e30 on both sides);
4. kernel B (paged decode partials) against its plain version at the
   decode shapes: bf16 arenas, then int8 arenas with their fp32 row-scale
   pools (split and tile kernels; GQA, holes, ragged lengths, t = 1 and
   t > 1, small shapes and the serving path's; within 1e-5 of the
   largest value); then fp32, bf16 and int8 arenas over the small shapes
   and the edges of the split walk (lengths bs k and bs k + 1, a full
   table, a sequence 8x longer than its mates, 8 and 9 query rows, a
   last live slot of -1);
5. kernels C and D (flash backward dq, dk/dv) against their plain
   versions: b = 2, h = 8 with 8 and 2 kv heads, l = 64 / 200 / 1024,
   d = 128, causal and not, bf16 and fp32; the bf16 cases also, with
   fp32 gradients, against the plain version that rounds P and dS to
   bf16 as the kernels and the TPU kernels do (rounded_ok; so
   are every masked and offset variant in phases 14 and 18 and the
   training shape in phase 13); then FlashAttentionFunction's
   gradients on the card against the plain versions on the CPU, fp32;
   then a probe of P's bf16 rounding (dO = I), rectangular lq != lk, a
   misaligned q view, and two launches equal bit for bit; then the fp32
   kernels at ViT-Base's width (b 64, h 12, d 64, not causal): l 197
   against their plain versions at BWD_TOL_REL, and two launches at the
   path's l 256 equal bit for bit (check_vit_bwd); then the fp32 kernel
   A at the same width, l 197 and 256, against its plain version at
   FWD_F32_TOL_REL, two launches bit-equal (check_vit_fwd);
6. kernels E and F: E (embedding gather) against its plain version, exactly:
   dims 32 / 64 / 13, fp32 and bf16, ids [4096] and [512, 26] with
   repeats, -1 and ids past the table; F (row updates), each of
   its four rules (sgd, momentum, adam, adagrad), against its plain
   version within 1e-6 relative, dims 32 and 13, unique ids mixed with -1
   and ids past the table; rows the ids do not name (and their slots)
   must stay bit-identical; then the grouped wrappers of E and F (one
   launch for many tables) against their plain versions at small
   shapes: dims 13, 32, 40 and 64, E in fp32 and bf16, 5 tables of
   different vocab and GROUP_TABLES + 3 (two launches), a table with
   no ids, -1 ids and ids past the end, each table with its own
   learning rate and count for F, and a table 4 bytes off 16-byte
   alignment (the scalar path); E equal, F within 1e-6, untouched rows
   bit-identical, one launch per GROUP_TABLES tables; then kernel G
   (dense optimizer updates),
   each of its five rules and momentum without Nesterov, fp32 and bf16,
   against its plain version within 1e-6: a 0-d scalar, (7, 33),
   1,000,003 elements and a view one element into its storage; then
   element counts at the edges of a thread's vector and a block's 256
   vectors, each tensor in turn 4 bytes off 16-byte alignment;
7. the serving slice at the flagship transformer_lm width (vocab 32000,
   seq_len 1024, embed 1024, 8 heads, 8 layers, bf16, seeded random
   weights): 16 greedy requests, 8 sharing a 256-token prefix, through
   the port's GenerationServer (8 slots, paged KV, block 16, prefix
   sharing). Every request must finish with its full token count and
   the serving kernels (A, B) must have launched during that run. The
   same 16 requests again with kv_cache_dtype='int8' (int8 arenas, fp32
   row scales): 16/16 finished, the int8 split and tile kernels launched
   and the float ones not. Then a 2-layer model at the same width, with
   weights made by numpy, runs one prompt and 8 decode steps on the card
   and on the CPU (plain versions); the logits must agree; and a small
   fp32 int8-cache model does the same within 1e-4;
8. where a decode step's time goes (host clock, torch.profiler), with
   bf16 arenas and with int8 arenas;
9. the training slice at the same flagship width (bf16 compute over fp32
   parameters, AdamW 3e-4, weight decay 0.01): the port's RecordWriter
   writes token records of 1025 tokens, and LocalExecutor(minibatch 8,
   max_steps 4) trains on them. Every loss must be finite and the first
   near its value at initialisation, and kernels A, C and D must each
   launch once per layer in every step. Then a 2-layer model at the same
   width with numpy weights takes one train_step in bf16 on the card and
   on the CPU: the loss and each parameter's gradient norm must agree;
   and one profiled step shows where a training step's time goes;
10. the DLRM slice at bench.py's width (26 tables x 1,200,000 rows x 32,
   fp32, minibatch 4096, SGD 0.01): the port's RecordWriter writes
   Criteo-like records, LocalExecutor trains 4 steps and evaluates once.
   Every loss must be finite and the first within its statistical bound
   of its expectation at initialisation; every step must launch E once
   and F once for all 26 tables (the grouped wrappers), and no
   one-table wrapper, and the evaluation E once; sampled rows of table 0
   that the
   records touch must have moved and sampled untouched rows must be
   bit-identical; probs_auc must lie in [0, 1]. Then steps on a pre-built
   batch with ids uniform over the 1.2M rows are timed and profiled, and
   a small DLRM (4 tapped tables of 20000 x 32, numpy weights) takes one
   fp32 step on the card and on the CPU: loss and every parameter within
   1e-5, and each parameter's change in the step within 1e-3 of it;
11. the dense update API (path B) at 64M fp32 elements, the size of
   scripts/bench_optimizer_kernels.py: each rule takes 3 steps through
   its public function, kernel G launching once per step;
12. kernels E and F against their plain versions at the DLRM path's
   size (a 1,200,000 x 32 fp32 table, the 4096 ids of one column of the
   uniform batch, each rule of F over them deduplicated), then grouped
   over the 26 tables and the batch's 26 columns (E equal to the
   per-table plain versions; F each rule within 1e-6 with its own
   learning rate and count per table, untouched rows bit-identical);
   kernel G
   against its plain version at 64M, each rule;
13. kernel timings at the main paths' shapes (A at the serving and the
   training shape; CUDA events, graph-replayed for device time; E and F
   over 26 distinct tables and id columns with L2 flushed before each
   round, one table a call and grouped, one call a step, as the step
   issues them; B also cold, 8 calls over disjoint
   arena pairs as a decode step's layers, L2 flushed), beside the
   plain version, a library call where one computes the same function,
   and the bound implied by the card's published peaks;
14. the mask variants of A, C, D (window, segments, both) and B (window:
   float and int8 split and tile kernels) against their plain versions
   at small shapes (fp32 and bf16, causal or not, windows 1, 2, 37, 300,
   ragged segments, GQA groups 1-4; paged t 1, 3, 8, 9, 128 with groups
   1, 2, 4, windows shorter than the tile) and at the paths' shapes (b =
   8, h = 8, l = 1024, d = 128 with window 256 and with packed segments;
   the windowed decode step and suffix tile), within the unmasked
   kernels' limits;
15. the windowed paths (attn_window = 256 at the flagship width): the 16
   requests served with bf16 and with int8 arenas (16/16, the window
   variants of A and B launched and the unwindowed ones not), a small
   windowed fp32 model's greedy streams on the card equal to the CPU's,
   4 LocalExecutor training steps (A, C, D's window variants once per
   layer in every step);
16. the packed paths: the packed family (transformer_lm_packed, 128-token
   rows) 4 LocalExecutor steps at the flagship width over document
   records; the flagship at seq_len 1024 on packed rows (pack_sequences
   over documents of 64-1024 tokens, then bench.py's packed=4 layout),
   2 + 4 Trainer steps each; the segment variants once per layer in
   every step; a packed row's logits against its documents run alone;
17. the mask variants timed at the paths' shapes, beside a bound over
   the pairs the mask keeps, the plain version and
   F.scaled_dot_product_attention with the same boolean mask;
18. ring attention's pos_offset variants of A, C and D against their
   plain versions: small shapes (fp32 and bf16, causal or not, windows
   none, 8, 24, 64, offsets 0, -l, l, l + 1, segments on every other
   case, fp32 gradients for bf16 inputs), then the ring path's shape (b
   2, h 8, 1024-row shards, d 128, window 1536; offsets 1024, 2048 and
   -1024 with a ring-like global lse);
19. the windowed ring's rotation loop in one process: every rank's
   rotations at l 4096 over 4 shards through the per-rotation functions
   the distributed ring calls, merged by lse, against unsharded
   windowed attention on the card;
20. the sp training path: the flagship at seq_len 4096, minibatch 2,
   over 4 rank processes that share the card through a gloo group
   (this script run as `chip_smoke.py --sp-rank R PORT DIR`; the
   exchange stages through host memory), 2 steps each of the causal
   ring, the ring with attn_window 1536 and Ulysses, against the
   single-device port Trainer on the same batch and params: losses
   within their limit, parameters bit-identical across ranks, each
   step's launches per kernel variant summed over the ranks equal to
   the ring's rotation table (72 forward launches a windowed step, 40 of
   them with an offset); a small fp32 windowed ring step card against
   CPU. The loss is the zoo's partial form reduced over the mesh (no
   logits gather). Then, in the same rank processes: the causal ring
   with fused_head (the chunked head on each rank's rows), 2 steps
   against the single-device fused run, peak allocation per rank beside
   the unfused ring's; the flagship through LocalExecutor on {"dp": 2,
   "sp": 2} with a checkpoint every step, 2 steps against the
   single-device causal run, launches per variant equal to the ring's
   table at sp 2 times dp 2, world rank 0 alone writing, and version 1
   restored on all four ranks with step 2 replayed bit-identical
   (sha256) to the uninterrupted run; BERT-base (phase 33's width,
   minibatch 16, seq 512) on {"dp": 2, "sp": 2}, 2 steps against its
   single-device run, the non-causal ring's table, after A, C and D
   (C and D writing fp32 gradients, the d-64 grad_f32 instances) are
   held against their plain versions at its rotation shape (b 8, h 12,
   256-row shards, d 64). The single-device references run in the main
   process while the ranks work. Its step times are no sp speed
   figure;
21. the offset variants timed at the ring's one-shard-back rotation,
   beside a bound over the pairs the mask keeps, the plain version and
   SDPA with the same boolean mask;
22. checkpoints and crash recovery at the flagship width (after phase
   11): LocalExecutor trains 6 steps at 2 a task over token records,
   with a checkpoint every 2 steps (2 kept) and a job state dir. Run 1,
   a process of its own (this script run as `chip_smoke.py --ckpt-run
   1 DIR`), dies by SIGKILL from EDL_FAULT_SPEC=local_get_task:kill:1:
   skip=2 fetching its third task: rc -9 after 4 steps, version-2 and
   version-4 on disk, verify_checkpoint of version 4. Run 2, another
   process, restores version 4 (checkpoint_dir_for_init) and the job
   state and trains only the last task, to step 6. Run 3 trains the 6
   steps here without a stop: run 1's and run 2's losses and run 2's
   version-6 parameters and AdamW slots must equal run 3's bit for bit
   (else within what two uninterrupted runs differ by, both printed).
   A, C and D launch once per layer in every step of the three runs. A
   server built by serving/main.py with --checkpoint_dir serves 4
   greedy requests (A and B launched) with the tokens of a server over
   run 3's parameters. Then one save of run 3's state, synchronous
   (device to host, serialize + sha256, write + rename) and async (the
   ms the loop pays, steps during the write), and a restore;
23. the serving engine's other modes at the flagship width (bf16,
   seeded weights, 8 slots, block 16), each serving the 16 requests and
   one 512-token prompt submitted after them: the plain paged engine
   (the reference), the dense engine with a bf16 and with an int8 cache,
   speculative decode (k = 2) with a random 2-layer draft and with the
   target as its own draft, chunked prefill (128-token tiles, 8 ms a
   tick), the engine with the step profiler, and the self-draft and
   chunked runs again with it (where their ticks spend their time), then
   the dense step under torch.profiler. Each mode's launches of A,
   B split and B tile must equal what the run did (A once a layer a
   monolithic prefill, the draft's at every seat; B's split kernel once
   a layer a step or verify and a tile of up to 8 rows, its tile kernel
   once a layer a wider tile; the dense engine no B), each stream must
   equal the reference's or diverge only where the reference's top two
   logits are within LOGIT_TOL_REL of the largest (logits_trace; the int8
   dense engine against phase 7's int8 paged run), and the self-draft
   must accept MODES_ACCEPT_MIN of its proposals. Hot reload: a server
   built by serving/main.py follows a checkpoint dir at version 1 while
   8 requests decode, version 2 is renamed into it, the watcher swaps
   between steps: no token dropped, every weight equal to version 2's
   fp32 value cast to its dtype bit for bit, a later request at version
   2 with the tokens of a fresh server over version 2. Then the flagship
   width at 2 layers in fp32: the greedy streams of every mode on the
   card and of the paged engine on the CPU identical. Then B's split
   kernel timed at the verify tile's shape (b 8, t 3);
24. the elastic training job at the flagship width over phase 22's
   token records (6 steps of 8 at 2 a task): (1) a Master served over
   the port's HTTP transport on localhost and one Worker in this
   process (master_addr=, device cuda) train the 6 steps; A, C and D
   launch once a layer a step, and the losses, parameters and AdamW
   slots equal bit for bit a Trainer fed the batches the worker's
   stream must give (the records of the dispatched tasks in order
   through the zoo's dataset_fn: its shuffle buffer spans the stream's
   tasks, so phase 22's LocalExecutor, which shuffles each task alone,
   is not that reference); every call's round trip and every step's
   wall time are kept; (2) `python -m elasticdl_tpu_torch.client.main
   train --num_workers 1 --device cuda --need_tensorboard
   --tensorboard_log_dir D --job_state_dir S` as a process under an
   EDL_TRACE_DIR: rc 0, its job status Succeeded and its last checkpoint
   equal to (1)'s state bit for bit; the master's and worker 0's span
   exports hold one task_dispatch span sealed ok a task (3) with exactly
   one worker_task child each, its task id equal; the master's event
   file, read by read_event_file (a table-free CRC32C, sharing no code
   with the writer), holds its recovery gauges (master/restarts and
   master/recovery_requeued_tasks, 0 at step 0); (3) a Master here and
   LocalInstanceManager with two worker processes over 2 epochs, their
   spans exported to a trace directory: the first worker seen holding
   tasks is killed by SIGKILL, its phase Failed, its tasks requeued, a
   worker with a new id launched without spending a relaunch, the job
   done with every range reported done once an epoch and
   all_workers_failed never true; each requeued range's first dispatch
   span is still open in the servicer (the dispatcher requeues under a
   new task id, so nothing seals it, as in the JAX servicer) and a later
   one on another worker is sealed ok; every sealed span is ok, each of
   a surviving worker's has one worker_task child in its export, and
   the killed worker exported none (SIGKILL skips atexit); the kill to
   the new worker's first get_task and each worker's start-up (its
   timeline stamps) are kept; the `master_worker` line's `traces`;
25. the lifecycle after pretraining at the flagship width (inside phase
   22's temporary directory, over its records): (1) remat "", "full" and
   "dots" each take 2 Trainer steps at minibatch 8 from the same seeded
   state on the same batches: losses and parameters equal remat ""'s
   bit for bit, A 16 launches a step under remat (8 without), C and D 8,
   each mode's peak memory kept; remat ""'s state is saved as the dense
   checkpoint; (2) a lora_rank=8, remat "full" model with
   trainable_pattern "lora" restores it with strict=False: its first
   loss equals the dense model's on the same batch bit for bit, and
   after 4 steps every base tensor equals the checkpoint's and every
   adapter has moved; its state is saved; (3) a Master over the
   transport with export_saved_model and an in-process Worker restored
   from that checkpoint train 16 of phase 22's records (2 steps) and
   SavedModelExporter(merge_lora=True) writes the export at the train
   end: load_exported equals merge_lora of the worker's state bit for
   bit, the merged dense model's fp32 logits lie within
   LIFE_MERGE_TOL_REL of the adapter model's, and the export's bytes
   and its write and load seconds are kept; (4) quantize_params of the
   export, saved as a checkpoint and read by serving/main.py's
   build_model (dequantized once), serves the 16 requests through the
   paged engine beside the float export: launches as the runs did, each
   int8 stream equal to the float one or leaving it where the float
   run's top two logits lie within LOGIT_TOL_REL; quantized_bytes
   against the float bytes; then the same checkpoint read by build_model
   under EDL_SERVING_FUSED_DEQUANT=1 (the int8 leaves held resident,
   dequantized inside every forward) serves them again, both int8 passes
   admitted under a held job: its 16 streams equal the once-at-load
   pass's token for token and its A / B launches equal them; each int8
   pass's resident weight bytes, peak allocated bytes over the pass,
   decode tokens/s and TTFT p50 are kept, and their ratios
   (`lifecycle.int8.fused`); (5) beam_search_generate with 4 beams,
   full forwards and KV-cached, equal tokens (2 layers, fp32); on that
   2-layer target, whose greedy rows each hold many distinct tokens,
   speculative_generate with gamma 4 and a draft that differs from it
   in one product accepts strictly between none and all of its
   proposals, so rounds commit the batch's shortest accepted prefix,
   and its tokens equal greedy's or leave them at a near-tie; a 2-layer
   draft warm-started from the export (warm_start_draft) and distilled
   on windows of random tokens, the distribution the export trained on
   (distill_draft, 40 Adam steps over 4 batches: the last pass's mean
   KL must lie below the first pass's on the same windows; A, C, D
   launched as its forwards and backwards do); speculative_generate
   with gamma 4 before and after distillation, each row's tokens equal
   to autoregressive_generate's greedy ones or leaving them at a
   near-tie; acceptance and tokens/s against greedy;
26. the host-DRAM embedding tier and the DeepFM family at the zoo's
   widths (embedding_dim 64, input_length 10, fc_unit 64, SGD 0.1), over
   frappe-like records of vocabulary 5383 (gen_frappe_like, two record
   dirs of 4 batches of 512): (1) deepfm_host_embedding through
   LocalExecutor with the native store, 8 steps, E 2 launches a step
   (one a table) and F none; deepfm_edl_embedding (dense tier) from the
   same dense weights, its tables the host stores' initial rows: losses
   and every touched row within HOST_LOSS_RTOL / HOST_LOSS_ATOL; the
   same host-tier steps on the CPU within the same; (2) 4 steps with a
   checkpoint holding the host leaves, a fresh executor resumed from it
   for 4 more: losses, dense parameters and every host row equal to the
   8 uninterrupted steps bit for bit; (3) the trained model exported
   with its host rows and served by make_serving_fn on 256 held-out
   rows: predictions equal to the executor's forward, the caller's
   stores unchanged (row count and bytes); (4) the scale: 20 steps of
   4096 rows of 10 ids uniform over [1, 10,000,000) in the host tier
   (step p50 / p99 and its split: prepare, h2d, device, d2h, apply;
   rows a step, store rows and bytes, device busy share), then the same
   batches from the same weights and initial rows in the HBM sparse-row
   tier (deepfm_edl_embedding at input_dim 10,000,000: a 2.56 GB table
   and its 40 MB bias on the card, E and F 2 launches a step) with
   losses within HOST_SCALE_LOSS_RTOL, and the host / HBM step ratio;
27. the serving replica on the wire at the flagship width (bf16, seeded
   weights, paged, block 16, prefix sharing, 8 slots): a port replica
   with its transport on port 0 in this process; (1) the 16 requests,
   one client thread each through ServingStub.generate_stream, admitted
   in spec order while the scheduler waits on a held job (so they are
   seated and batched as phase 7's in-process run's): every stream
   equal to that run's token for token, A, B split and B tile launched
   and no other serving variant, server_status over the wire equal to
   the run (16 more completed and admitted, tokens_generated up by the
   sum of max_new_tokens); (2) the 16 sent together, timed: tokens/s
   against phase 7's in-process run, client TTFT p50 / p99; (3)
   server_status round trips; (4) `python -m
   elasticdl_tpu_torch.serving.main --device cuda --port 0` at the
   flagship as a process: seconds to SERVING_READY, the first request
   streamed and SIGTERM sent after its first chunk: the stream ends
   with all its tokens (equal to the in-process run's, or leaving them
   at a near-tie, since it decodes alone) and the process exits 0;
28. the paged pool's host spill tier and the disaggregated handoff at
   the flagship width (bf16, seeded weights, paged, block 16, prefix
   sharing, 8 slots; 48 prompts of its own generator, half 1008 tokens
   (63 full blocks) and half 1000 (62 and an 8-token suffix), 16 new
   tokens each, every pass admitted while the scheduler waits so its
   seats and batches are those of every other pass): (1) a replica of
   512 blocks (the dense-equivalent pool) with a 2 GiB host tier (4096
   blocks) serves the 48 twice: nearly every chain spills in pass 1 and
   revives by upload in pass 2; each pass's streams equal, token for
   token, those of the same pass on a 3200-block replica that keeps
   every chain resident; spills, revive uploads, prefill_tokens_revived
   = revived blocks x 16, the host bytes within budget after every
   scheduler tick, and every launch of A and B in both passes held
   against its plain version on the same inputs (fwd_ok, PAGED_TOL_REL);
   TTFT by pass, the profiler's revive_upload ms and the upload rate;
   (2) a 256 MiB host tier (512 blocks, 8 chains): chains drop, the
   budget holds, pass 2's whole chains give the resident pass-2 streams,
   dropped ones prefill again and give the pass-1 streams, and chains
   cut short leave pass 2's streams only at a near-tie; (3) int8 arenas,
   16 prompts twice: every revived block's rows and scales hash equal to
   what its spill read; (4) a prefill replica and a decode replica on
   the transport (port 0): for 16 prompts (1008 tokens, and 1005: a
   13-token suffix, B's tile kernel) a HandoffCoordinator runs the
   prefill-only generate and export_chain on the one and transfer_chain
   on the other, and the decode replica's stream equals a unified
   replica's after its own prefill-only warm-up; the decode replica
   launches no A and one B tile a layer a 1005-token prompt, every
   launch held to its plain version; ServerStatus shows the roles, the
   chain counters and transfers_inflight 0, an abort counts, a payload
   of the wrong block size comes back ok=False; chain bytes, export /
   transfer / gather / upload ms, MB/s, TTFT after a handoff against a
   cold prefill; (5) serving/main.py's parser and build_server take
   --kv_host_bytes and --role, and both reach ServerStatus;
29. the serving router at the flagship width: replicas R1 and R2 (512
   blocks, 8 slots, block 16, prefix sharing) in this process, R3 the
   serving entry's main() in a process of its own (this script run as
   `chip_smoke.py --router-replica LOG <serving.main flags>`), and
   `python -m elasticdl_tpu_torch.serving.router_main --port 0` as its
   own process in front of the three; each replica's engine operations
   (every seat with its request's trace id, every decode step) are
   logged. (1) 24 requests (16 sharing a 512-token prefix with 96-token
   suffixes, 8 distinct 992-token prompts, 32 new tokens; 16 through
   router_generate_stream, 8 through router_generate) in waves of 8
   concurrent RouterStub calls, each carrying its own trace id: routed
   = completed = 24, affinity hits + misses = 24, hits > 0, shed 0, A
   and B launched in this process's replicas; (5) in the quiet fleet
   router_status's fleet TTFT p50 / p90 / p99 equal the percentiles of
   the replicas' own ttft_hist buckets summed here, every ReplicaStatus
   names its address, role, breaker and KV counters, the SLO block its
   three objectives; (2) six interleaved passes of 16 fresh requests of
   the same shapes at concurrency 8, direct to R1 and through a second
   router fronting R1 alone: tokens/s, client TTFT, the router's e2e
   p50 / p99, router_status round trips, each router's seconds to
   ROUTER_READY; (3) 16 streams of 896-token prompts, 128 new tokens,
   and R3 SIGKILLed once each has its first chunk (or once each that
   R3 seated has, and R3 seats no more: its slots are full): every stream
   completes or ends UNAVAILABLE ("mid-stream") after its chunks, within
   the dispatch timeout, the failed ones exactly R3's, R3 out of the
   rotation within lease + 2 polls (3.5 s), then 8 more requests
   complete with nothing shed; (6) each replica's logged operations
   replayed on a fresh replica's engine (the same seats and batches),
   step 1's with every A and B launch held to its plain version, and
   every completed stream of steps 1-3 equal, token for token, to its
   replay; (4) a prefill-role and a decode-role replica behind a router:
   8 cold 1008-token prompts (16 new) one at a time through
   router_generate_stream, 8 handoffs and no fallback, no A on the
   decode replica, each stream equal to a unified replica's after its
   own prefill-only warm-up; then a router with EDL_FAULT_SPEC=
   disagg_handoff:drop:1 falls back once and its stream equals the
   unified replica's cold one. Every child that dies unasked fails the
   phase; routers exit 0 on SIGTERM;
30. the rest of the router tier at the flagship width, every router a
   `python -m elasticdl_tpu_torch.serving.router_main` process that maps
   no torch library: R1 and R2 in this process (serving.main's
   build_server over checkpoint version 1 of the seeded flagship,
   --reload_poll_secs 0, engine operations logged) and a reference
   replica over the same weights. (1) `--cells 2` over R1 and R2 and a
   CellFront here: 16 requests at once (8 sharing a 512-token prefix
   whose family cell 0 owns, every third unary), cell 0 SIGKILLed once
   one of its streams has a chunk: requests it had accepted reroute
   through cell 1, a stream past its first chunk fails UNAVAILABLE
   ("mid-stream"), none is lost; the cell supervisor restarts cell 0,
   which replays the journal and lists both replicas; a third cell with
   no --replica learns them from the journal; (2) rollouts over one
   journal: version 2 (version 1's bytes) under 8 live streams commits
   canary first with one swap per replica and no live failure; version
   4 (a shard removed) aborts with no swap; version 3 (perturbed, valid
   digests) fails parity on the canary and rolls back to version 2;
   version 5 with EDL_FAULT_SPEC=rollout_swap:kill:1:skip=1 loses its
   controller mid-wave and a router given only --rollout_journal_dir
   commits it with no replica swapped twice; client TTFT before and
   during the healthy rollout; (3) `--autoscale --min_replicas 1
   --max_replicas 2` over flagship serving.main processes it spawns:
   spawn and adopt, a burst of 48 scales to 2, a SIGKILLed replica is
   replaced, idle time drains back to 1 (SIGTERM, exit 0, retired), and
   the router SIGKILLed and restarted on its journal re-adopts the live
   replica with no spawn; each adopted replica's answer to a prompt
   sent alone equals the reference replica's; no accepted request is
   lost; then R1's and R2's operations of step (1) replayed on a fresh
   engine with every A and B launch held to its plain version, and
   every completed stream of step (1) equal to a replay of its trace.
31. the preprocessing layers and the tabular and CTR zoo (the JAX
   package's heart_functional_api, census_dnn_model x 3,
   census_wide_deep_model, census_model_sqlflow dnn and wide&deep, and
   dac_ctr wide_deep / deepfm / dcn / xdeepfm, found by their JAX
   --model_def strings in elasticdl_tpu_torch/model_zoo): each model
   takes TAB_STEPS LocalExecutor steps and one evaluation on the card
   over records the copied generators write (gen_heart_like,
   gen_census_raw, gen_criteo_like), at its published widths, dac_ctr at
   max_hashing_bucket_size 10^6 (38 tables of 5.50 M rows at dims 1 and
   8, Adam), one model at a time, each freed before the next; minibatch
   TAB_BATCH for the tabular models and TAB_CTR_BATCH for the CTR ones
   (see their comment); every loss finite, the metrics in [0, 1], no
   kernel launched by the training (the tables are plain lookups, as the
   JAX zoo's nn.Embed), and the first step's loss on the card within
   TAB_LOSS_TOL_REL of the CPU port's from the same weights and batch;
   per model its parameter bytes, peak memory, step ms and p50, and
   dataset_fn's records/s on the host apart from the step; the step of
   the simplest and the heaviest CTR model profiled (TAB_PROFILED). Then
   kernel E through the preprocessing path: an embedding_column over the
   concatenated_categorical_column of the 38 dac_ctr groups (5.50 M rows
   x 8, ids from the CTR transform of 2048 records, a tenth of the slots
   and one whole row PADDING_ID), sum and mean combiners, against the
   same layer on the CPU within TAB_EMB_TOL_REL of the largest value; E
   launched once a lookup; E timed at that shape beside its plain
   version and F.embedding.
32. the vision zoo (the JAX package's mnist_functional_api,
   mnist_subclass, cifar10_functional_api, cifar10_subclass,
   resnet50_subclass and imagenet_resnet50, found by their JAX
   --model_def strings in elasticdl_tpu_torch/model_zoo) at their
   published widths over records the copied generators write
   (gen_mnist_like, gen_cifar10_like, gen_imagenet_like at 224 x 224 x
   3, 1000 classes): each model takes VIS_STEPS LocalExecutor steps at
   minibatch VIS_BATCH (the README quickstart's) and one evaluation,
   one model at a time; the first step at dropout rate 0, its loss
   within VIS_LOSS_TOL_REL and its BatchNorm running averages within
   VIS_STATS_TOL_REL of the CPU port's from the same weights and batch
   (TF32 off), the later steps with dropout on; the checkpoint of step
   VIS_CKPT_STEP restored into a fresh Trainer, every leaf (parameters,
   batch_stats, momentum traces) bit for bit and its eval logits within
   VIS_RESTORE_TOL_REL of the saved state's; per model its step ms and
   p50, peak memory above what the process held before, parameter
   bytes and dataset_fn's records/s; no kernel launched (conv,
   BatchNorm and pooling are cuDNN / aten calls, as they are XLA ops in
   the JAX package). Then the README quickstart on the port:
   `client.main train` of mnist_functional_api over 2 x 256
   gen_mnist_like records, 2 worker processes sharing the card,
   minibatch 64, rc 0 and the job Succeeded.
33. the bidirectional encoders and the iris model on CSV rows: BERT-base
   (bert.bert.custom_model: vocab 30522, seq 512, 768, 12 heads, 12
   layers, bf16, minibatch 16, over gen_tokens_like records) and
   ViT-Base (vit.vit.custom_model: 224 px, patch 14, 1000 classes, 768,
   12 heads, 12 layers, fp32, minibatch 64, dropout on, over
   gen_imagenet_like records) take ENC_STEPS LocalExecutor steps each;
   every step launches A, C and D once a layer (not causal, head_dim 64)
   and nothing else; step ms and p50, tokens/s or images/s, peak
   memory. Then BERT-base's packed row with the most documents against
   each document alone within ENC_PACKED_TOL_REL of the largest logit,
   and one training step of 16 packed rows (A, C and D's segments
   variant once a layer); the first step of a 2-layer model at each
   encoder's full width on the card against the CPU port from the same
   weights and batch (STEP_LOSS_TOL_REL, STEP_GRAD_NORM_TOL_REL); the
   iris model over gen_iris_csv files through LocalExecutor on the card
   and on the CPU, losses within ENC_IRIS_LOSS_TOL_REL, and through
   `client.main train` with one worker (rc 0, Succeeded). A, C and D are
   then held to their plain versions and timed at both encoders' path
   shapes (ENC_KERNEL_SHAPES) beside their bound, the plain version,
   SDPA and aten's backward.
34. the metrics plane and tail forensics on the serving fleet
   (metrics_plane_phase), at the flagship's serving configuration
   (bf16, paged, block 16, MP_SLOTS slots): (a) phase 16's requests
   twice through an in-process replica, admitted while the scheduler
   waits on a held job, with the plane off (forensics off, no metrics
   port) and on (forensics on, /metrics on port 0 scraped from another
   thread throughout, every page through the port's parser): the
   streams token for token and A's and B's launches by variant equal,
   decode tokens/s of both and the scrape's and render's ms a record;
   (b) two `serving.main --device cuda --kv_paged 1 --metrics_port 0
   --port 0 --tensorboard_log_dir D_i` processes (started early, see
   below) behind a `router_main --metrics_port 0 --tensorboard_log_dir
   D_r` process, all under a temporary EDL_TRACE_DIR; 24
   routed requests (the 16, then 4 with deadlines too tight for their
   64 tokens, then after the first scrape 4 with loose deadlines) while
   observability.collector.scrape_fleet scrapes the router MP_SCRAPES
   times MP_INTERVAL_S apart; every page parses clean; the router's
   completed plus errors is the 24 sent; its fleet TTFT buckets equal
   the replicas' summed `edl_serving_ttft_ms` buckets; the status RPCs'
   counters equal the pages'; `slow_cause_counts` nonzero and equal to
   its family; the collector CLI against the live router (rc 0, a valid
   report, no torch in its /proc/<pid>/maps); SIGTERM (each process
   exports its spans); build_report with a TTFT objective at half the
   run's smallest TTFT bucket validates, alerts on ttft_p99 and resolves
   at least one exemplar to a trace attributed to a cause of CAUSES,
   the span evidence complete; the dump CLI over the directory, and one
   router_generate -> dispatch -> serve tree for every routed request;
   after the SIGTERM each replica's `.serving` and the router's
   `.router` event file parse clean under read_event_file and their last
   `serving/<counter>_total` and `router/<counter>_total` scalars equal
   the final status reads (the router's routed the 24 sent;
   `metrics_plane.tensorboard`).
35. the runtime-health plane (runtime_health_phase): (i) phase 34's
   requests through an in-process replica over phase 34's model, the
   plane off and on, each after a warmup of every shape the path takes
   at this configuration (one request a prefill bucket, MP_SLOTS
   requests seated together so the decode step runs each active-slot
   count, the prefix index flushed after) and the steady mark: streams
   and A / B launches equal (RH_LAUNCHES), the plane's self-report after
   the pass (jit_compiles > 0, steady_recompiles 0, stalls 0, "ok"),
   decode tokens/s on over off, the compiles by site and the
   accountant's idle unaccounted bytes a record; (ii) the stall drill
   (after scripts/run_stall_drill.py): an in-process router and replica
   supervisor own two `serving.main --device cuda` flagship replicas;
   seat 0 is born with RH_STALL_SPEC, seat 1 with RH_LEAK_SPEC, both
   with --stall_after_secs RH_STALL_AFTER_S and a drill EDL_HEALTH_DIR;
   stalled_kill_after_secs RH_STALLED_KILL_AFTER_S, wedged_after_secs
   RH_WEDGED_AFTER_S. The leak is convicted from the sibling's idle
   reconciles, under 8 MiB before it (no leak logged yet), at least 8
   MiB after; then RH_LONG long requests: seat 0 self-reports stalled
   within RH_STALL_AFTER_S + 2 s of the dispatch (its lease still
   valid), the router drops it, the supervisor kills it before
   wedged_after_secs, a clean replacement goes live, every wedged
   request completes on the sibling, RH_POST more after the
   replacement, 9 of 9 OK; the one bundle valid (validate_bundle), its
   ring non-empty and the scheduler asleep in the fault hook in its
   stacks; (iii) SIGUSR2 (sent in phases 24 and 34) to live processes: a
   replica and router_main of phase 34, the master and the worker of
   phase 24's CLI job, each dumping all its threads' stacks to
   sigusr2-<pid>.txt and serving on.
Every process the script starts writes stall bundles to one
EDL_HEALTH_DIR: after phases 27-30 and 34 (and 35) it must hold none.
Right after the build the script starts, beside the kernel checks
(untimed work), the children later phases use: the sp ranks (20) and
checkpoint run 1 (22), each waiting at a gate once torch is imported
and its CUDA context made (their timed work starts at the go), phase
34's two replicas (ready, then idle), the README quickstart of phase 32
and the iris job of phase 33 (whole jobs, no timed section); before the
first timed section it waits until each is at its gate, ready or done.

It prints a `kernels` JSON line, a `serving` JSON line (the int8 run
under "int8"), a `training` JSON line, a `dlrm` JSON line, a `dense`
JSON line, a `packed`, a `windowed`, an `sp`, a `checkpoint`, a
`serving_modes`, a `master_worker`, a `lifecycle`, a
`host_embedding` JSON line (whose E and F launches by run also ride the
`kernels` line as `launches_host_embedding`), a `serving_wire` line
(A's and B's launches on that path ride the `kernels` line as
`launches_serving_wire`), a `serving_tiers` line (its A and B
launches by part ride the `kernels` line as `launches_serving_tiers`,
its checked launches' errors as `serving_tiers_max_abs_err`) and a
`serving_router` line (its A and B launches in this process's replicas
ride the `kernels` line as `launches_serving_router`, its replayed
launches' errors as `serving_router_max_abs_err`) and a
`serving_router_tier` line (likewise `launches_serving_router_tier`
and `serving_router_tier_max_abs_err`) and a `tabular_zoo` line (E's
launches through embedding_column ride the `kernels` line as
`launches_tabular_zoo`, by wrapper, their errors as
`tabular_zoo_max_abs_err`, E's timing there as `tabular_zoo_timing`)
and a `vision_zoo` line (its launches, all 0, ride the `kernels` line as
`launches_vision_zoo`) and an `encoder_zoo` line (its launches by part
ride the `kernels` line as `launches_bert_vit`; A, C and D timed at the
bert and vit shapes are the `kernels` entries named `..._bert` and
`..._vit`) and a `metrics_plane` line (its A and B launches by pass ride
the `kernels` line as `launches_metrics_plane`) and a `runtime_health`
line, each with
its own seconds (`phase_s`; the kernel checks' and timings' and the whole
script's under `serving_modes.kernels_phase_s` and `.script_s`), the
nvidia-smi line and, last, {"ok": true, "device": {...}}.
fp32 comparisons run with TF32 off (torch.backends.cuda.matmul / cudnn
allow_tf32 = False).
"""

import atexit
import contextlib
import gc
import glob
import hashlib
import itertools
import json
import math
import os
import random
import re
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
from datetime import timedelta

_T0 = time.perf_counter()  # the script's start: its log lines count from it


def _start_build_early():
    """Run as the script with no arguments on a machine with nvcc: start
    the kernels' build (ops/_build.py imports no torch) on a thread
    before the heavy imports below, which then overlap it. main() joins
    it."""
    if __name__ != "__main__" or sys.argv[1:]:
        return None
    if not (shutil.which("nvcc") or os.path.exists(
            os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda",
                         "bin", "nvcc"))):
        return None
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from elasticdl_tpu_torch.ops import _build as build_mod

    out = {"t0": time.perf_counter()}

    def run():
        try:
            out["report"] = build_mod.build()
        except BaseException as e:  # noqa: BLE001 - re-raised in main
            out["error"] = e
        out["t_end"] = time.perf_counter()

    out["thread"] = threading.Thread(target=run, daemon=True)
    out["thread"].start()
    return out


_EARLY_BUILD = _start_build_early()

import numpy as np
import torch
import torch.nn.functional as F

from elasticdl_tpu_torch.api.callbacks import SavedModelExporter
from elasticdl_tpu_torch.api.distill import distill_draft, warm_start_draft
from elasticdl_tpu_torch.api.exporter import (
    export_model,
    flax_tree,
    load_exported,
    make_serving_fn,
)
from elasticdl_tpu_torch.api.finetune import merge_lora
from elasticdl_tpu_torch.api.generation import (
    autoregressive_generate,
    beam_search_generate,
    kv_layout,
    speculative_generate,
)
from elasticdl_tpu_torch.api.local_executor import LocalExecutor
from elasticdl_tpu_torch.api.quantization import (
    holds_int8,
    load_params,
    quantize_params,
    quantized_bytes,
)
from elasticdl_tpu_torch.checkpoint.saver import (
    CheckpointSaver,
    flatten_state,
    get_latest_checkpoint_version,
    load_checkpoint,
    params_tree_leaves,
    restore_state_from_checkpoint,
    verify_checkpoint,
)
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.hash_utils import string_to_id
from elasticdl_tpu_torch.common.model_utils import (
    get_dict_from_params_str,
    get_model_spec,
    load_model_spec_from_module,
)
from elasticdl_tpu_torch.convert import (
    dlrm_params_from_flax,
    flatten_params,
    params_from_flax,
)
from elasticdl_tpu_torch.data import packing
from elasticdl_tpu_torch.data import recordio_gen as port_recordio_gen
from elasticdl_tpu_torch.common import job_status
from elasticdl_tpu_torch.data.dataset import Dataset, pad_batch
from elasticdl_tpu_torch.data.example_codec import (
    decode_example,
    encode_example,
)
from elasticdl_tpu_torch.data.reader.recordio_reader import (
    RecordIODataReader,
)
from elasticdl_tpu_torch.data.record_format import RecordWriter, Scanner
from elasticdl_tpu_torch.embedding import layer as embedding_layer
from elasticdl_tpu_torch.embedding.host_bridge import attach_from_spec
from elasticdl_tpu_torch.master.instance_manager import LocalInstanceManager
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.state_store import JobStateStore
from elasticdl_tpu_torch.master.task_dispatcher import Task, TaskType
from elasticdl_tpu_torch.model_zoo import deepfm_edl_embedding as dzoo_edl
from elasticdl_tpu_torch.model_zoo.dac_ctr.feature_config import (
    FEATURE_GROUPS,
)
from elasticdl_tpu_torch.model_zoo.dac_ctr.feature_transform import (
    group_max_ids,
    transform_feature,
)
from elasticdl_tpu_torch.model_zoo import deepfm_host_embedding as thost
from elasticdl_tpu_torch.model_zoo import dlrm as dzoo
from elasticdl_tpu_torch.model_zoo import flax_layers as vis_layers
from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo
from elasticdl_tpu_torch.model_zoo import transformer_lm_packed as tpacked
from elasticdl_tpu_torch.model_zoo.bert import bert as bert_zoo
from elasticdl_tpu_torch.model_zoo.transformer_lm import (
    TransformerLM,
    kv_quantize_rows,
)
from elasticdl_tpu_torch.native.host_embedding import HostEmbeddingStore
from elasticdl_tpu_torch.observability import collector, dump, forensics
from elasticdl_tpu_torch.observability.histogram import LogLinearHistogram
from elasticdl_tpu_torch.observability.metrics import (
    add_counts,
    render_prometheus,
)
from elasticdl_tpu_torch.observability.promparse import parse_prometheus_text
from elasticdl_tpu_torch.observability.slo import default_router_slos
from elasticdl_tpu_torch.observability.tracing import group_by_trace, recorder
from elasticdl_tpu_torch.proto import messages as wire_pb
from elasticdl_tpu_torch.proto import service as wire_service
from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.ops import attention as att
from elasticdl_tpu_torch.ops import embedding_ops as eo
from elasticdl_tpu_torch.ops import optimizer_kernels as ok
from elasticdl_tpu_torch.ops import update_math as um
from elasticdl_tpu_torch.parallel import context_parallel as cp
from elasticdl_tpu_torch.preprocessing import feature_column as fcol
from elasticdl_tpu_torch.serving import main as serving_main
from elasticdl_tpu_torch.serving.disagg import HandoffCoordinator
from elasticdl_tpu_torch.serving.engine import StepProfiler
from elasticdl_tpu_torch.serving.kv_pool import PagedKVPool
from elasticdl_tpu_torch.serving.server import GenerationServer, ServingConfig
from elasticdl_tpu_torch.training.trainer import Trainer
from elasticdl_tpu_torch.worker.worker import Worker

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core peak, fp32 peak
# outside the tensor cores, and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

FLAGSHIP = dict(vocab_size=32000, seq_len=1024, embed_dim=1024,
                num_heads=8, num_layers=8, dtype=torch.bfloat16)
FLASH_TOL_OUT, FLASH_TOL_LSE = 2e-2, 1e-3
# the fp32 forward against its plain version, out and lse each by max
# |err| / max |ref| (lse over the rows that see a key): both sum in fp32
# in another order and round nothing else; at most 1.7e-6 (out) and
# 7.3e-7 (lse) over the masked and offset checks (GQA, ragged l, d 64
# and 128) and 1.4e-6 / 2.1e-7 at ViT's width in this script's first
# run with the FFMA kernel (an H100 80GB HBM3). FLASH_TOL_OUT and
# FLASH_TOL_LSE stay for bf16 inputs.
FWD_F32_TOL_REL = 1e-5
# the bf16 forward's lse against the plain version that rounds as it
# does (bf16_operands=True): the two differ only in the order of fp32
# sums (S, l), while the unrounded plain version's fp32 scale moves the
# lse by about 0.3% of the largest score (1e-3 to 1e-2 at unit inputs);
# so within FWD_ROUNDED_TOL_LSE of the rounded version, and
# FWD_ROUNDED_CLOSER times further from the unrounded one where that
# one differs by FWD_ROUNDED_APART or more
FWD_ROUNDED_TOL_LSE = 1e-4
FWD_ROUNDED_APART = 1e-3
FWD_ROUNDED_CLOSER = 10
# the bf16 forward's out against the rounded plain version by
# rms_rel_err, as rounded_ok holds C and D: the kernel rounds P against
# each 64-key tile's running max where the plain version rounds it
# against the row's max, so outputs here and there land a bf16 unit
# apart and the largest error says little. At most 2.2e-4 over every
# bf16 check of A in the first card run of this check (an H100 80GB
# HBM3), the unrounded version 1.94x as far or more (it also scales q
# in fp32; the probe of check_fwd_rounding reads the kernel's rounded P
# back). So: within FWD_ROUNDED_TOL_RMS, and FWD_ROUNDED_RMS_CLOSER
# times closer to the rounded version than to the unrounded one where
# that one differs by FWD_ROUNDED_RMS_APART or more
FWD_ROUNDED_TOL_RMS = 5e-4
FWD_ROUNDED_RMS_APART = 1e-4
FWD_ROUNDED_RMS_CLOSER = 1.5
PAGED_TOL_REL = 1e-3
PAGED_TIMING_SEED = 11  # the paged timings' own generator (time_kernels)
LOGIT_TOL_REL = 5e-2
# flash backward against its plain version, max |err| / max |ref| per
# output: fp32 sums in another order (1e-4); bf16 outputs rounded once
# more or less than the plain version's (2^-8 of the largest value)
BWD_TOL_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# the bf16 backward kernels against the plain version that rounds P and
# dS to bf16 where they do (bf16_operands=True), both writing fp32
# gradients, by rms_rel_err per output (the root-mean-square error over
# masked_rel_err's scale; rounded_ok). The two round at the same places
# (the probe of check_bwd_rounding reads the kernel's rounded P back).
# What remains is the fp32 summation order, and the odd P or dS element
# that lies within a few fp32 units of a bf16 rounding midpoint and
# rounds the other way on one side, moving its row by up to about 1e-3
# of the scale; so the largest error says little, and the mean square is
# held: at most 1.3e-5 over every variant in the first full card runs,
# while the unrounded plain version lies 4.2e-5 to 3.4e-4 away
# (unrounded_rms_rel_err), 22x the rounded one's distance or more. So:
# within BWD_ROUNDED_TOL_REL, and, where the unrounded version differs
# measurably (BWD_ROUNDED_APART or more), BWD_ROUNDED_CLOSER times closer
# to the rounded version than to it
BWD_ROUNDED_TOL_REL = 5e-5
BWD_ROUNDED_APART = 2e-5
BWD_ROUNDED_CLOSER = 4
# a bf16 train step on the card against the same step on the CPU: the
# loss, and each parameter's gradient norm, by relative error (bf16
# rounding at other places in cuBLAS and the CPU kernels)
STEP_LOSS_TOL_REL = 1e-2
STEP_GRAD_NORM_TOL_REL = 5e-2
# kernel F against its plain version, max |err| / max |ref| per table:
# the rules of csrc/update_rules.cuh round each operation as the plain
# version does (no fused multiply-add), so the tables should be equal;
# the limit allows reassociation a compiler might still do
ROW_TOL_REL = 1e-6
SERVING_KERNELS = ("flash_fwd", "paged_decode", "paged_decode_tile")
SERVING_INT8_KERNELS = ("flash_fwd", "paged_decode_int8",
                        "paged_decode_tile_int8")
# the int8 paged kernels against their plain version, max |err| / max
# |ref| of o, l and m in fp32: the split kernel folds the row scales into
# scores and weights as the plain version does, the tile kernel scales
# each row element instead (rounding only), and both sum in another order
PAGED_INT8_TOL_REL = 1e-5
# a small fp32 int8-cache model on the card against the CPU, TF32 off:
# logits within 1e-4 of the largest logit, both runs attending over the
# card's int8 rows (compare_cuda_cpu_int8). Each device's own quantizer
# may put an element one step apart from the other's, where fp32
# rounding puts it on the other side of a .5 (one such v element moved
# the prefill logits 6.4e-4 in the first card run); those are counted,
# and the scales (amax / 127 of rows computed on two devices) must agree
# to 1e-4
INT8_LOGIT_TOL_REL = 1e-4
INT8_SCALE_TOL_REL = 1e-4
# the dense-update kernel against its plain version, max |err| / max
# |ref| per output: the rules round each operation as the plain version
# does (no fused multiply-add), so the outputs should be equal
DENSE_TOL_REL = 1e-6
DENSE_N = 64 * 1024 * 1024  # scripts/bench_optimizer_kernels.py's N_PARAMS
DENSE_STEPS = 3
ADAM_STEP = 3  # the 1-based update count of the Adam checks
TRAINING_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
TRAIN_BATCH, TRAIN_STEPS = 8, 4
# the DLRM slice at bench.py's width (run_dlrm_bench)
DLRM = dict(table_size=1_200_000, num_tables=26, embedding_dim=32)
DLRM_BATCH, DLRM_STEPS = 4096, 4
# the DLRM path's wrappers: one launch of E and one of F for all 26
# tables; the one-table wrappers launch the same kernels for one table
DLRM_KERNELS = ("embedding_gather_many", "row_update_many")
DLRM_TABLE_KERNELS = ("embedding_gather", "row_update")
# a small DLRM step on the card against the CPU, fp32 with TF32 off:
# loss (relative) and every parameter after the step (absolute); and the
# step's change of each parameter tensor, max |card - cpu| / max |cpu|
# of the change: the card rounds p + change (a fused multiply-add) a
# unit of p's last place away from the CPU at most, 3.7e-9 for a table
# value near 0.05 against a largest change near 6e-5 (under 1e-4 of
# it), while an update of the wrong scale (lr off by a factor s) is off
# by |1 - s| of it
DLRM_STEP_TOL = 1e-5
DLRM_STEP_DELTA_TOL_REL = 1e-3


class SmokeFailure(Exception):
    pass


def check(cond, message):
    if not cond:
        raise SmokeFailure(message)


def log(*args):
    """A log line, stamped with the script's seconds so far."""
    print("[%7.1f]" % (time.perf_counter() - _T0), *args, flush=True)


def _events_ms(run, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _captured(fn, warmup=3):
    """fn() captured in a CUDA graph, after `warmup` calls on a side
    stream, and replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def timed_ms(fn, iters=50, warmup=3):
    """(device ms, eager ms) of one fn() call. Device: fn captured in a
    CUDA graph, replayed `iters` times between CUDA events, divided by
    iters, so the host's launch overhead is not in it. Eager: `iters`
    plain calls between events, which includes the wrapper's host work
    whenever the host is slower than the card."""
    graph = _captured(fn, warmup)
    return _events_ms(graph.replay, iters), _events_ms(fn, iters)


# bytes written to evict the card's L2 (50 MB on an H100) before a round
L2_FLUSH_BYTES = 256 << 20


def timed_cold_ms(calls, iters=20, graph=True):
    """(device ms, eager ms) of one call of `calls`: callables over
    disjoint data (one per table, as a step of one-table calls issues
    them back to back, or one call over all the tables).
    Before each round of all the calls the L2 is flushed, so no call
    finds in L2 what an earlier round brought there, as on the path,
    where every step brings new ids. Device: the round captured in one
    CUDA graph (graph=False: plain calls, for a function that syncs with
    the host), timed between CUDA events, divided by the calls. Eager:
    the round's plain calls, the same way."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")

    def round_():
        for call in calls:
            call()

    def per_call(run):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        total = 0.0
        for _ in range(iters):
            flush.zero_()
            start.record()
            run()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters / len(calls)

    if not graph:
        round_()
        ms = per_call(round_)
        return ms, ms
    return per_call(_captured(round_, warmup=1).replay), per_call(round_)


def bound_ms(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def flash_work(b, h, hkv, lq, lk, d, itemsize, causal=True):
    """(operations, bytes) of one flash forward, causal unless `causal`
    is False: 4*d operations per visible (query, key) pair; q, k, v read
    once, out and the fp32 lse written once."""
    pairs = (sum(min(i + 1, lk) for i in range(lq)) if causal
             else lq * lk)
    flops = 4 * d * pairs * b * h
    nbytes = itemsize * d * (2 * b * h * lq + 2 * b * hkv * lk) + 4 * b * h * lq
    return flops, nbytes


def paged_work(lengths, hkv, n_rows, d, itemsize, m, int8=False):
    """(operations, bytes) of one paged partials call over the live rows
    only: each cached row k_pos < length is read once per kv head (K and
    V, and for int8 arenas their two fp32 scales), 4*d operations per
    (query row, live row); fp32 query rows and partials move once, plus
    the table and lengths."""
    live = int(sum(lengths))
    b = len(lengths)
    flops = 4 * d * n_rows * hkv * live
    nbytes = (2 * (itemsize * d + (4 if int8 else 0)) * hkv * live
              + 4 * b * hkv * n_rows * (2 * d + 2) + 4 * b * (m + 1))
    return flops, nbytes


# ------------------------------------------------------------ kernel checks


def flash_inputs(gen, b, h, hkv, l, d, dtype):
    def mk(heads):
        return torch.randn(b, heads, l, d, generator=gen).to("cuda", dtype)

    return mk(h), mk(hkv), mk(hkv)


def flash_fwd_errs(q, k, v, out, lse, causal, masks):
    """Kernel A's out and lse against its plain version on the same
    inputs, the one that rounds as the kernel does (bf16_operands=True;
    the same arithmetic for fp32): {"max_abs_err", "lse_max_abs_err"};
    for fp32 also out's and lse's errors over the largest reference
    value ("max_rel_err", "lse_max_rel_err", lse over the rows that see a
    key) and the rows that see a key on one side only
    ("empty_rows_apart"); for bf16 out's "rms_rel_err", and the
    distances of lse and out from the unrounded plain version
    ("unrounded_lse_max_abs_err", "unrounded_rms_rel_err"). An empty
    row's lse is +1e30 on both sides."""
    ref, ref_lse = att.flash_attention_plain(q, k, v, causal=causal,
                                             bf16_operands=True, **masks)
    errs = {"max_abs_err": (out.float() - ref.float()).abs().max().item(),
            "lse_max_abs_err": (lse - ref_lse).abs().max().item()}
    if q.dtype == torch.float32:
        seen = ref_lse < -0.5 * att.NEG_INF
        lse_err = (lse - ref_lse).abs()[seen]
        errs.update(
            max_rel_err=errs["max_abs_err"] / max(
                ref.abs().max().item(), 1e-30),
            lse_max_rel_err=lse_err.max().item() / max(
                ref_lse[seen].abs().max().item(), 1e-30)
            if lse_err.numel() else 0.0,
            empty_rows_apart=int(
                (seen != (lse < -0.5 * att.NEG_INF)).sum().item()))
    if q.dtype == torch.bfloat16:
        e_out, e_lse = att.flash_attention_plain(q, k, v, causal=causal,
                                                 **masks)
        errs["rms_rel_err"] = rms_rel_err(out.float(), ref.float())
        errs["unrounded_lse_max_abs_err"] = (lse - e_lse).abs().max().item()
        errs["unrounded_rms_rel_err"] = rms_rel_err(out.float(),
                                                    e_out.float())
    return errs


def fwd_ok(e):
    """Whether one of flash_fwd_errs's results holds: for fp32 out and
    lse within FWD_F32_TOL_REL and no row empty on one side only; else
    FLASH_TOL_OUT and FLASH_TOL_LSE, and for bf16 FWD_ROUNDED_TOL_LSE
    with the unrounded version FWD_ROUNDED_CLOSER times further where it
    differs by FWD_ROUNDED_APART or more, and out's FWD_ROUNDED_TOL_RMS
    with the unrounded version FWD_ROUNDED_RMS_CLOSER times further where
    it differs by FWD_ROUNDED_RMS_APART or more."""
    if "lse_max_rel_err" in e:
        return (e["max_rel_err"] <= FWD_F32_TOL_REL
                and e["lse_max_rel_err"] <= FWD_F32_TOL_REL
                and e["empty_rows_apart"] == 0)
    ok = (e["max_abs_err"] <= FLASH_TOL_OUT
          and e["lse_max_abs_err"] <= FLASH_TOL_LSE)
    if "unrounded_lse_max_abs_err" in e:
        apart = e["unrounded_lse_max_abs_err"]
        ok = ok and e["lse_max_abs_err"] <= FWD_ROUNDED_TOL_LSE and (
            apart < FWD_ROUNDED_APART
            or e["lse_max_abs_err"] * FWD_ROUNDED_CLOSER <= apart)
        rms, rms_apart = e["rms_rel_err"], e["unrounded_rms_rel_err"]
        ok = ok and rms <= FWD_ROUNDED_TOL_RMS and (
            rms_apart < FWD_ROUNDED_RMS_APART
            or rms * FWD_ROUNDED_RMS_CLOSER <= rms_apart)
    return ok


def check_flash(gen):
    """Kernel A against flash_attention_plain at the prefill shapes
    (fwd_ok). Returns the worst errors."""
    worst = {}
    cases = [(8, 8, 64), (8, 8, 200), (8, 8, 1024), (8, 2, 200)]
    for h, hkv, l in cases:
        q, k, v = flash_inputs(gen, 1, h, hkv, l, 128, torch.bfloat16)
        out, lse = att.flash_forward(q, k, v, causal=True)
        torch.cuda.synchronize()
        e = flash_fwd_errs(q, k, v, out, lse, True, {})
        log("flash h=%d hkv=%d lq=%d bf16: %s" % (h, hkv, l, e))
        check(torch.isfinite(out.float()).all().item(), "flash: non-finite")
        check(fwd_ok(e), "flash kernel disagrees with its plain version at "
              "h=%d hkv=%d lq=%d: %s" % (h, hkv, l, e))
        _worst(worst, "flash_fwd", e)
    return worst["flash_fwd"]


def check_fwd_rounding(gen):
    """A probe of the bf16 kernel A's rounding of P: with one key tile
    (lq = lk = 64 <= d, so the running max is the row max) and V = I,
    out = bf16(bf16(P) / l) is the kernel's rounded P read back, held in
    bf16 units to the rounded plain version's out, causal or not: at
    most a thousandth of the visible elements (those at a bf16 rounding
    midpoint) one unit apart, none further. The same out with P kept in
    fp32, bf16(P / l), lies a unit apart at a twentieth of them or more,
    so the probe tells the two apart. Returns a summary."""
    bf16 = torch.bfloat16
    summary = {"elements": 0, "apart": 0, "max_units": 0,
               "fp32_p_apart": 0}
    for causal in (False, True):
        l, d = 64, 128
        q, k, _v = flash_inputs(gen, 1, 1, 1, l, d, bf16)
        v = torch.zeros(1, 1, l, d, device="cuda", dtype=bf16)
        v[0, 0, torch.arange(l), torch.arange(l)] = 1
        out, _lse = att.flash_forward(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref, _lse, p, lsum = att._flash_plain_f32(
            q, k, v, causal, d ** -0.5, None, None, None, 0, True)
        fp32_p = p / lsum.clamp(min=1e-30)[..., None]
        visible = p > 0

        def units(a, b):
            # out >= 0: bf16 bit patterns count bf16 units
            return (a[..., :l].to(bf16).view(torch.int16).int()
                    - b[..., :l].to(bf16).view(torch.int16).int()).abs()[
                        visible]

        apart = units(out, ref)
        summary["elements"] += int(visible.sum().item())
        summary["apart"] += int((apart > 0).sum().item())
        summary["max_units"] = max(summary["max_units"],
                                   int(apart.max().item()))
        summary["fp32_p_apart"] += int((units(out, fp32_p) > 0).sum().item())
        check(torch.equal(out[..., l:], torch.zeros_like(out[..., l:])),
              "the probe's output columns past lk are not 0")
    log("flash fwd rounding probe: %s" % summary)
    check(summary["max_units"] <= 1
          and summary["apart"] * 1000 <= summary["elements"],
          "the bf16 forward rounds P otherwise than its plain version: %s"
          % summary)
    check(summary["fp32_p_apart"] * 20 >= summary["elements"],
          "the forward's probe cannot tell a rounded P from an fp32 one: "
          "%s" % summary)
    return summary


def check_flash_instances(gen):
    """Each of the bf16 kernel A's 32 instances (d 64 and 128; causal or
    not; window 37 or none; segment ids or none; pos_offset 0, or -50
    causal (its first 50 rows see no key) and 77 not causal) against the
    rounded plain version (fwd_ok): b 2, h 4 over 2 kv heads, lq 200
    (ragged against the 64-row tiles), lk 200 under a window, else 136
    or 333 (rectangular; segments as a (q_seg, k_seg) pair, some rows
    then see no key). The first case also with a q view that does not
    start on 16 bytes (the wrapper copies it) and launched twice, equal
    bit for bit. Returns {"instances", "worst": {variant: worst errors}}."""
    bf16 = torch.bfloat16
    worst, n = {}, 0
    for d, causal, window, segs, shifted in itertools.product(
            (64, 128), (False, True), (None, 37), (False, True),
            (False, True)):
        offset = (-50 if causal else 77) if shifted else 0
        lq = 200
        lk = lq if window else (136 if segs else 333)
        q = flash_inputs(gen, 2, 4, 2, lq, d, bf16)[0]
        _q, k, v = flash_inputs(gen, 2, 4, 2, lk, d, bf16)
        masks = {"window": window, "pos_offset": offset}
        if segs:
            masks.update(q_seg=packed_segments(gen, 2, lq).cuda(),
                         k_seg=packed_segments(gen, 2, lk).cuda())
        if n == 0:
            flat = torch.empty(q.numel() + 1, device="cuda", dtype=bf16)
            flat[1:] = q.flatten()
            q = flat[1:].view(q.shape)
            check(q.data_ptr() % 16 != 0, "the probe view is aligned")
        out, lse = att.flash_forward(q, k, v, causal=causal, **masks)
        if n == 0:
            again = att.flash_forward(q, k, v, causal=causal, **masks)
            check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
                  "the bf16 forward differs between two launches")
        torch.cuda.synchronize()
        e = flash_fwd_errs(q, k, v, out, lse, causal, masks)
        variant = att._variant("flash_fwd", window, segs, shifted)
        where = ("d=%d causal=%s window=%s segments=%s offset=%d lq=%d "
                 "lk=%d" % (d, causal, window, segs, offset, lq, lk))
        log("flash fwd instance %s: %s" % (where, e))
        check(torch.isfinite(out.float()).all().item(),
              "%s: non-finite output at %s" % (variant, where))
        check(fwd_ok(e), "%s disagrees with its rounded plain version at "
              "%s: %s" % (variant, where, e))
        _worst(worst, variant, e)
        n += 1
    check(n == 32, "checked %d of the 32 instances" % n)
    return {"instances": n, "misaligned_q_and_repeat": True,
            "worst": worst}


def paged_inputs(gen, b=8, hkv=8, group=1, t=1, d=128, bs=16, m=64,
                 num_blocks=640, lengths=None, dtype=torch.bfloat16):
    if lengths is None:
        lengths = torch.randint(1, 1000, (b,), generator=gen)
    lengths = torch.as_tensor(lengths)
    table = torch.full((b, m), -1, dtype=torch.int32)
    perm = torch.randperm(num_blocks, generator=gen)
    used = 0
    for i in range(b):
        n = -(-int(lengths[i]) // bs)
        table[i, :n] = perm[used:used + n].to(torch.int32)
        used += n
    pools = [torch.randn(num_blocks, bs, hkv, d, generator=gen).to(
        "cuda", dtype) for _ in range(2)]
    qf = (torch.randn(b, hkv, group * t, d, generator=gen)
          * d ** -0.5).to("cuda")
    return (qf, pools[0], pools[1], table.cuda(),
            lengths.to(torch.int32).cuda()), lengths.tolist()


def rel_err(a, b):
    if b.numel() == 0:
        return 0.0
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def masked_rel_err(a, b):
    """rel_err with the largest reference value taken as at least 1, the
    size of the unit-variance inputs: under a window of 1 a row sees only
    its own key, so dS = P (dP - delta) is 0 in exact arithmetic and dq,
    dk are the rounding of unit-size terms (about 1e-6), which a relative
    error of their own would read as 0.5-1. Where an output's largest
    value is 1 or more, this is rel_err."""
    if b.numel() == 0:
        return 0.0
    return ((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()


def rms_rel_err(a, b):
    """The root-mean-square of a - b over max(max |b|, 1), the scale of
    masked_rel_err."""
    if b.numel() == 0:
        return 0.0
    return ((a - b).float().pow(2).mean().sqrt()
            / b.abs().max().clamp(min=1.0)).item()


def rounded_ok(e):
    """Whether one of rounded_bwd_errs's entries holds (see
    BWD_ROUNDED_TOL_REL)."""
    rms, apart = e["rms_rel_err"], e["unrounded_rms_rel_err"]
    return rms <= BWD_ROUNDED_TOL_REL and (
        apart < BWD_ROUNDED_APART or rms * BWD_ROUNDED_CLOSER <= apart)


def rounded_bwd_errs(q, k, v, out, lse, do, **kw):
    """{kernel: {"rms_rel_err", "max_rel_err"}} of the bf16 kernels C
    and D against the plain version that rounds P and dS to bf16 as
    they do, both with fp32 gradients (no output rounding in the way),
    the worst over (dq, delta) and (dk, dv): rms_rel_err, which
    rounded_ok holds with the RMS error against the unrounded plain
    version, and masked_rel_err, reported. `kw`: the causal flag and
    masks."""
    kw = dict(kw, grad_dtype=torch.float32)
    dq, delta = att.flash_backward_dq(q, k, v, out, lse, do, **kw)
    dk, dv = att.flash_backward_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    pdq, pdelta = att.flash_backward_dq_plain(q, k, v, out, lse, do,
                                              bf16_operands=True, **kw)
    pdk, pdv = att.flash_backward_dkv_plain(q, k, v, do, lse, pdelta,
                                            bf16_operands=True, **kw)
    edq, _ = att.flash_backward_dq_plain(q, k, v, out, lse, do, **kw)
    edk, edv = att.flash_backward_dkv_plain(q, k, v, do, lse, pdelta, **kw)
    return {name: {"rms_rel_err": max(rms_rel_err(a, b) for a, b in pairs),
                   "max_rel_err": max(masked_rel_err(a, b)
                                      for a, b in pairs),
                   "unrounded_rms_rel_err": max(rms_rel_err(a, b)
                                                for a, b in unrounded)}
            for name, pairs, unrounded in (
                ("flash_bwd_dq", ((dq, pdq), (delta, pdelta)), ((dq, edq),)),
                ("flash_bwd_dkv", ((dk, pdk), (dv, pdv)),
                 ((dk, edk), (dv, edv))))}


def partials_errs(got, ref):
    """Relative errors of paged partials (o, l, m) against the plain
    version's; m over the rows that saw a key (l > 0) only, since the
    -1e30 of an empty row would hide any other error."""
    (o, l, mx), (po, pl, pm) = got, ref
    live = pl > 0
    return [rel_err(o, po), rel_err(l, pl), rel_err(mx[live], pm[live])]


def quantize_pools(args):
    """paged_inputs' bf16 arenas as int8 arenas with their fp32 scale
    pools, quantized on the card by the model's quantizer."""
    (k8, ks), (v8, vs) = (kv_quantize_rows(p) for p in args[1:3])
    return (args[0], k8, v8, args[3], args[4], ks, vs)


def check_paged(gen):
    """Kernel B against paged_decode_partials_plain at the decode shapes
    (t = 1 decode and t = 8 through the split kernel, t = 40 through the
    tile kernel), bf16 arenas, -1 padded tables."""
    worst_abs = worst_rel = 0.0
    for t in (1, 8, 40):
        args, _lengths = paged_inputs(gen, t=t)
        o, l, mx = att.paged_decode_partials(*args)
        torch.cuda.synchronize()
        po, pl, pm = att.paged_decode_partials_plain(*args)
        errs = partials_errs((o, l, mx), (po, pl, pm))
        e_abs = (o - po).abs().max().item()
        log("paged t=%d: rel err o %.3g l %.3g m %.3g" % (t, *errs))
        check(all(e <= PAGED_TOL_REL for e in errs),
              "paged kernel disagrees with its plain version at t=%d: %s"
              % (t, errs))
        worst_abs, worst_rel = max(worst_abs, e_abs), max(worst_rel,
                                                          max(errs))
    log("paged bf16 decode shapes, worst rel err %.3g (limit %g)"
        % (worst_rel, PAGED_TOL_REL))
    return worst_abs, worst_rel


def check_paged_int8(gen):
    """The int8 split and tile kernels against paged_decode_partials_plain
    on the same int8 arenas and scale pools: small shapes (groups of 1, 2
    and 4, d 64 and 128, blocks of 4 and 16, ragged lengths with a length
    0 and an unallocated slot inside a live range; 1, 2, 4 and 8 query
    rows through the split kernel, 20 and 160 through the tile kernel),
    then the serving path's shapes (8 slots at t = 1 over lengths under
    1000; a 128-row suffix tile over a 256-token prefix). Returns (max
    |err|, max rel err) and the path shape's worst relative error."""
    worst_abs = worst_rel = path_rel = 0.0
    small = [dict(b=3, hkv=2, group=group, t=t, d=d, bs=bs, m=8,
                  num_blocks=40, lengths=[bs * 5 + 3, 0, bs * 2 + 1])
             for group, t in ((1, 1), (2, 1), (4, 1), (4, 2), (4, 5),
                              (4, 40))
             for d, bs in ((64, 4), (128, 16))]
    path = [dict(t=1), dict(b=1, t=128, lengths=[256])]
    for i, case in enumerate(small + path):
        args, lengths = paged_inputs(gen, **case)
        if i < len(small):
            table = args[3]
            table[0, 1] = -1  # a hole inside sequence 0's live range
        args = quantize_pools(args)
        o, l, mx = att.paged_decode_partials(*args)
        torch.cuda.synchronize()
        po, pl, pm = att.paged_decode_partials_plain(*args)
        errs = partials_errs((o, l, mx), (po, pl, pm))
        e_abs = max((o - po).abs().max().item(), (l - pl).abs().max().item())
        rows = case.get("group", 1) * case["t"]
        log("paged int8 %s (%d query rows, %s): rel err o %.3g l %.3g m %.3g"
            % ("path" if i >= len(small) else "small", rows,
               "split" if rows <= att.SPLIT_MAX_ROWS else "tile", *errs))
        check(all(torch.isfinite(x).all().item() for x in (o, l)),
              "paged int8: non-finite partials")
        check(max(errs) <= PAGED_INT8_TOL_REL,
              "int8 paged kernel disagrees with its plain version at %s: %s"
              % (case, errs))
        worst_abs, worst_rel = max(worst_abs, e_abs), max(worst_rel,
                                                          max(errs))
        if i >= len(small):
            path_rel = max(path_rel, max(errs))
    log("paged int8, worst rel err %.3g (limit %g)"
        % (worst_rel, PAGED_INT8_TOL_REL))
    return worst_abs, worst_rel, path_rel


def paged_sweep_cases():
    """(case, hole) pairs of check_paged_sweep: paged_inputs keywords and
    the table slot of sequence 0 to unallocate (None: none). The small
    shapes of check_paged_int8 (groups 1, 2, 4; d 64 with blocks of 4, d
    128 with blocks of 16; lengths with a 0; a -1 hole inside a live
    range), then the edges of the split walk, which cuts each
    sequence's live keys across the blocks of a cluster: lengths bs k and
    bs k + 1, a full table (m bs), a sequence 8x longer than its batch
    mates, 8 and 9 query rows (the split / tile boundary), and a table
    whose last live slot is -1."""
    small = [(dict(b=3, hkv=2, group=group, t=t, d=d, bs=bs, m=8,
                   num_blocks=40, lengths=[bs * 5 + 3, 0, bs * 2 + 1]), 1)
             for group, t in ((1, 1), (2, 1), (4, 1), (4, 2), (4, 5), (4, 40))
             for d, bs in ((64, 4), (128, 16))]
    edge = dict(b=3, hkv=2, bs=16, m=8, num_blocks=40)
    edges = []
    for d in (64, 128):
        edges += [
            (dict(edge, d=d, lengths=[32, 33, 48]), None),
            (dict(edge, d=d, lengths=[128, 16, 1]), None),
            (dict(edge, d=d, lengths=[112, 14, 13]), None),
            (dict(edge, d=d, group=8, lengths=[77, 128, 31]), None),
            (dict(edge, d=d, t=9, lengths=[77, 128, 31]), None),
            (dict(edge, d=d, group=2, lengths=[77, 96, 5]), 4),
        ]
    return small + edges


def check_paged_sweep(gen):
    """Kernel B, split and tile, against paged_decode_partials_plain on
    fp32, bf16 and int8 arenas over paged_sweep_cases, each dtype within
    its limit (PAGED_TOL_REL for float arenas, PAGED_INT8_TOL_REL for
    int8). Returns {dtype: worst rel err}."""
    worst = {}
    for case, hole in paged_sweep_cases():
        for dtype in ("float32", "bfloat16", "int8"):
            args, _lengths = paged_inputs(
                gen, dtype=torch.bfloat16 if dtype == "int8"
                else getattr(torch, dtype), **case)
            if hole is not None:
                args[3][0, hole] = -1
            if dtype == "int8":
                args = quantize_pools(args)
            o, l, mx = att.paged_decode_partials(*args, t=case.get("t", 1))
            torch.cuda.synchronize()
            ref = att.paged_decode_partials_plain(*args, t=case.get("t", 1))
            errs = partials_errs((o, l, mx), ref)
            tol = PAGED_INT8_TOL_REL if dtype == "int8" else PAGED_TOL_REL
            check(all(torch.isfinite(x).all().item() for x in (o, l)),
                  "paged %s: non-finite partials at %s" % (dtype, case))
            check(max(errs) <= tol, "paged kernel disagrees with its plain "
                  "version on %s arenas at %s (hole %s): %s"
                  % (dtype, case, hole, errs))
            worst[dtype] = max(worst.get(dtype, 0.0), max(errs))
    log("paged sweep (%d cases per arena dtype), worst rel err: %s; limits "
        "%g (float), %g (int8)" % (len(paged_sweep_cases()), worst,
                                   PAGED_TOL_REL, PAGED_INT8_TOL_REL))
    return worst


# kernel G's rules: rule -> (slot tensors, the public wrapper's
# hyperparameters); the checks add momentum without Nesterov
DENSE_RULES = {
    "sgd": (0, dict(lr=0.01)),
    "momentum": (1, dict(lr=0.01, momentum=0.9, nesterov=True)),
    "adam": (2, dict(step=ADAM_STEP, lr=1e-3)),
    "adam_amsgrad": (3, dict(step=ADAM_STEP, lr=1e-3)),
    "adagrad": (1, dict(lr=0.01)),
}
DENSE_CASES = [(rule, kw) for rule, (_n, kw) in DENSE_RULES.items()] + [
    ("momentum", dict(DENSE_RULES["momentum"][1], nesterov=False))]


def dense_inputs(gen, rule, shape, dtype, offset=0):
    """(param, slots, grad) on the card; moments non-negative where the
    rule takes their root. offset > 0 starts every tensor `offset`
    elements into its storage, so the kernel takes its scalar path."""

    def mk(scale=1.0, positive=False):
        x = torch.randn(offset + math.prod(shape), generator=gen,
                        device=gen.device) * scale
        x = (x.abs() if positive else x).to("cuda", dtype)
        return x[offset:].view(shape)

    slots = [mk(0.1, positive=(rule == "adagrad" or k > 0))
             for k in range(DENSE_RULES[rule][0])]
    return mk(), slots, mk()


def dense_call(rule, kw, param, slots, grad):
    """The rule through its public wrapper (the dense update API);
    returns the new parameter and slots."""
    if rule == "adam_amsgrad":
        out = ok.adam_update(param, slots[0], slots[1], grad,
                             max_square=slots[2], **kw)
    else:
        out = {"sgd": ok.sgd_update, "momentum": ok.momentum_update,
               "adam": ok.adam_update, "adagrad": ok.adagrad_update}[rule](
            param, *slots, grad, **kw)
    return [out] if isinstance(out, torch.Tensor) else list(out)


def dense_plain(rule, kw, param, slots, grad):
    """The plain version on the hyperparameters the wrapper hands the
    kernel."""
    if rule == "sgd":
        hyper = [kw["lr"]]
    elif rule == "momentum":
        hyper = [kw["lr"], kw["momentum"], float(kw["nesterov"])]
    elif rule == "adagrad":
        hyper = [kw["lr"], 1e-10]
    else:
        hyper = [um.adam_alpha(kw["lr"], 0.9, 0.999, kw["step"]), 0.9,
                 0.999, 1e-8]
    return ok.dense_update_plain(rule, [param, *slots, grad], hyper)


def check_dense_update(gen):
    """Kernel G, each rule (momentum with and without Nesterov), against
    dense_update_plain on the same inputs: fp32 and bf16; a 0-d scalar,
    (7, 33), 1,000,003 elements (a scalar tail after the vector loop) and
    4096 elements 1 element into their storage (the scalar path). Max
    |err| / max |ref| per output within DENSE_TOL_REL; inputs unchanged.
    Returns the worst relative error."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for rule, kw in DENSE_CASES:
            errs = []
            for shape, offset in (((), 0), ((7, 33), 0), ((1_000_003,), 0),
                                  ((4096,), 1)):
                param, slots, grad = dense_inputs(gen, rule, shape, dtype,
                                                  offset)
                before = [t.clone() for t in (param, *slots, grad)]
                out = dense_call(rule, kw, param, slots, grad)
                torch.cuda.synchronize()
                ref = dense_plain(rule, kw, param, slots, grad)
                check(all(o.dtype == dtype and o.shape == param.shape
                          for o in out), "dense %s: output dtype/shape"
                      % rule)
                check(all(torch.equal(a, b) for a, b in
                          zip(before, (param, *slots, grad))),
                      "dense %s modified an input" % rule)
                errs += [rel_err(o.float(), r.float())
                         for o, r in zip(out, ref)]
            log("dense %s %s%s: rel err %.3g over 4 shapes" % (
                rule, str(dtype)[6:], "" if rule != "momentum" else
                " nesterov=%s" % kw["nesterov"], max(errs)))
            check(max(errs) <= DENSE_TOL_REL,
                  "dense %s %s disagrees with its plain version: %s"
                  % (rule, dtype, errs))
            worst = max(worst, max(errs))
    log("dense small shapes, worst rel err %.3g (limit %g)"
        % (worst, DENSE_TOL_REL))
    return worst


def misaligned(x):
    """A copy of x that starts 4 bytes into its storage (off the 16-byte
    alignment of the kernel's vector path)."""
    shift = 4 // x.element_size()
    buf = torch.empty(x.numel() + shift, dtype=x.dtype, device=x.device)
    out = buf[shift:].view(x.shape)
    out.copy_(x)
    return out


def check_dense_edges(gen):
    """Kernel G at the edges of a thread's chunk (one 16-byte vector) and
    a block's: for each rule (momentum with and without Nesterov), fp32
    and bf16, element counts of fewer than one vector, a vector and one,
    and a block less one, a block, a block and one, with every tensor
    aligned and then each tensor in turn 4 bytes off 16-byte alignment
    (the scalar path). Max |err| / max |ref| per output within
    DENSE_TOL_REL. Returns the worst relative error."""
    worst, cases = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        vec = 16 // torch.empty((), dtype=dtype).element_size()
        block = 256 * vec  # csrc/optimizer_update.cu: 256 threads a block
        for rule, kw in DENSE_CASES:
            for n in (vec - 1, vec + 1, block - 1, block, block + 1):
                param, slots, grad = dense_inputs(gen, rule, (n,), dtype)
                tensors = [param, *slots, grad]
                for off in [None] + list(range(len(tensors))):
                    args = [misaligned(x) if k == off else x
                            for k, x in enumerate(tensors)]
                    out = dense_call(rule, kw, args[0], args[1:-1], args[-1])
                    torch.cuda.synchronize()
                    ref = dense_plain(rule, kw, args[0], args[1:-1],
                                      args[-1])
                    errs = [rel_err(o.float(), r.float())
                            for o, r in zip(out, ref)]
                    check(max(errs) <= DENSE_TOL_REL,
                          "dense %s %s disagrees with its plain version at "
                          "%d elements, tensor %s misaligned: %s"
                          % (rule, dtype, n, off, errs))
                    worst = max(worst, max(errs))
                    cases += 1
    log("dense chunk edges (%d cases), worst rel err %.3g (limit %g)"
        % (cases, worst, DENSE_TOL_REL))
    return worst


def check_flash_bwd(gen):
    """Kernels C (dq, and delta) and D (dk/dv) against their plain
    versions, on the same inputs and the forward kernel's out and lse.
    The bf16 cases also against the plain version that rounds P and dS
    as the kernels do (rounded_bwd_errs, rounded_ok).
    Returns {kernel: {"max_abs_err", "max_rel_err",
    "rounded_max_rel_err"}}, worst over cases; rel is max |err| / max
    |ref| of each output."""
    worst = {"flash_bwd_dq": [0.0, 0.0], "flash_bwd_dkv": [0.0, 0.0]}
    worst_rounded = {}
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            for h, hkv, l in ((8, 8, 64), (8, 8, 200), (8, 8, 1024),
                              (8, 2, 200), (8, 2, 1024)):
                q, k, v = flash_inputs(gen, 2, h, hkv, l, 128, dtype)
                do = flash_inputs(gen, 2, h, h, l, 128, dtype)[0]
                out, lse = att.flash_forward(q, k, v, causal=causal)
                dq, delta = att.flash_backward_dq(q, k, v, out, lse, do,
                                                  causal=causal)
                dk, dv = att.flash_backward_dkv(q, k, v, do, lse, delta,
                                                causal=causal)
                torch.cuda.synchronize()
                pdq, pdelta = att.flash_backward_dq_plain(
                    q, k, v, out, lse, do, causal=causal)
                pdk, pdv = att.flash_backward_dkv_plain(
                    q, k, v, do, lse, pdelta, causal=causal)
                errs = {}
                for name, pairs in (
                        ("flash_bwd_dq", ((dq, pdq), (delta, pdelta))),
                        ("flash_bwd_dkv", ((dk, pdk), (dv, pdv)))):
                    rel = max(rel_err(a.float(), b.float()) for a, b in pairs)
                    e_abs = max((a.float() - b.float()).abs().max().item()
                                for a, b in pairs)
                    finite = all(torch.isfinite(a.float()).all().item()
                                 for a, _b in pairs)
                    errs[name] = rel
                    check(finite, "%s: non-finite output" % name)
                    check(rel <= BWD_TOL_REL[dtype],
                          "%s disagrees with its plain version at h=%d "
                          "hkv=%d l=%d causal=%s %s: rel err %.3g"
                          % (name, h, hkv, l, causal, dtype, rel))
                    worst[name][0] = max(worst[name][0], e_abs)
                    worst[name][1] = max(worst[name][1], rel)
                log("flash bwd h=%d hkv=%d l=%d causal=%d %s: rel err dq "
                    "%.3g, dk/dv %.3g" % (h, hkv, l, causal,
                                          str(dtype)[6:], errs["flash_bwd_dq"],
                                          errs["flash_bwd_dkv"]))
                if dtype != torch.bfloat16:
                    continue
                rounded = rounded_bwd_errs(q, k, v, out, lse, do,
                                           causal=causal)
                log("  against the rounded plain version (fp32 "
                    "gradients): %s" % rounded)
                for name, e in rounded.items():
                    check(rounded_ok(e),
                          "%s disagrees with its rounded plain version at "
                          "h=%d hkv=%d l=%d causal=%s: %s"
                          % (name, h, hkv, l, causal, e))
                    _worst(worst_rounded, name, e)
    return {name: {"max_abs_err": e[0], "max_rel_err": e[1],
                   "rounded_rms_rel_err":
                       worst_rounded[name]["rms_rel_err"],
                   "rounded_max_rel_err":
                       worst_rounded[name]["max_rel_err"],
                   "unrounded_rms_rel_err":
                       worst_rounded[name]["unrounded_rms_rel_err"]}
            for name, e in worst.items()}


# what one H100 SM holds for resident blocks: 65536 registers, 2048
# threads, 233472 bytes of shared memory (1024 of them reserved per block)
SM_REGISTERS, SM_THREADS = 65536, 2048
SM_SMEM, BLOCK_SMEM_RESERVED = 233472, 1024


def ptxas_entries(log):
    """[(mangled kernel name, registers, spill bytes, stack frame bytes)]
    from ptxas's report in a build log."""
    entries, entry, spill, stack = [], None, 0, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            stack = int(m.group(1))
            spill = int(m.group(2)) + int(m.group(3))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            entries.append((entry, int(m.group(1)), spill, stack))
            entry, spill, stack = None, 0, 0
    return entries


def _build_groups(entries, group_of):
    """{group: {"registers": {mask instance: registers}, "spill_bytes",
    "stack_bytes" (the largest stack frame), "smem_bytes", "threads",
    "blocks_per_sm"}} of the entries that `group_of` maps to (key,
    instance, smem bytes, threads), or None."""
    groups = {}
    for entry, regs, spill, stack in entries:
        found = group_of(entry)
        if found is None:
            continue
        key, instance, smem, threads = found
        group = groups.setdefault(key, {"registers": {}, "spill_bytes": 0,
                                        "stack_bytes": 0,
                                        "smem_bytes": smem,
                                        "threads": threads})
        group["registers"][instance] = regs
        group["spill_bytes"] += spill
        group["stack_bytes"] = max(group["stack_bytes"], stack)
    for group in groups.values():
        regs = -(-max(group["registers"].values()) // 8) * 8
        group["blocks_per_sm"] = min(
            SM_REGISTERS // (regs * group["threads"]),
            SM_SMEM // (group["smem_bytes"] + BLOCK_SMEM_RESERVED),
            SM_THREADS // group["threads"], 32)
    return groups


def _mask_flags(entry):
    """The "CWSO" flags (causal, window, segments, offset) of a bf16
    instance's Masks template argument, or None."""
    flags = re.search(r"MasksILb(\d)ELb(\d)ELb(\d)ELb(\d)E", entry)
    return "".join(flags.groups()) if flags else None


def flash_bwd_build_report(log):
    """csrc/flash_bwd.cu's kernel instances from ptxas's report in its
    build log: {"<kernel> d<D> <output dtype>": {"registers": {mask
    instance ("CWSO" flags of a bf16 instance: causal, window, segments,
    offset; "none" or "general" for the fp32 kernels, the general one
    taking its masks as runtime flags): registers}, "spill_bytes": spill
    stores and loads summed over the instances, "smem_bytes": a block's
    dynamic shared memory, "threads": a block's, "blocks_per_sm": what
    the most registers and the shared memory let one SM hold}}."""
    lib = att._bwd_lib()

    def group_of(entry):
        if "flash_bwd_d" not in entry:
            return None
        dkv = "flash_bwd_dkv" in entry
        tc = "_tcI" in entry
        d = int(re.search(r"Li(64|128)E", entry).group(1))
        if tc:
            out = "bf16 in, fp32 out" if "_tcIf" in entry else "bf16"
            instance = _mask_flags(entry)
        else:
            out = "fp32 in and out"
            instance = _f32_instance(entry)
        key = "%s%s d%d %s" % ("flash_bwd_dkv" if dkv else "flash_bwd_dq",
                               "_tc" if tc else "_f32", d, out)
        return (key, instance,
                lib.edl_flash_bwd_smem_bytes(int(dkv), int(tc), d),
                128 if tc else 2 * d)

    return _build_groups(ptxas_entries(log), group_of)


# opcodes an fp32 flash instance (A, C, D) must not hold: tensor-core
# products and conversions to or from a 16-bit or TF32 format
F32_FORBIDDEN = re.compile(r"^(?:[HID]G?MMA|F2F|.*BF16|.*TF32)")


def start_sass(lib_path):
    """(process, output file) of cuobjdump (the toolkit's, beside nvcc)
    disassembling a library in the background into a temporary file: it
    takes ~20 s for flash_bwd's; flash_f32_sass reads it."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    out = tempfile.TemporaryFile(mode="w+")
    return subprocess.Popen([cuobjdump, "-sass", lib_path], stdout=out,
                            stderr=subprocess.STDOUT, text=True), out


def flash_f32_sass(started, expected):
    """The fp32 flash kernels of one library as compiled (A's in
    flash_fwd's, C's and D's in flash_bwd's), from start_sass's process
    over it: per instance {"instructions", "ffma_share", "lds128"}; fails
    if an instance holds an opcode of F32_FORBIDDEN, so they stay exact
    fp32 FMAs, or if the library holds other than `expected` fp32
    instances."""
    proc, out = started
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with out:
        out.seek(0)
        sass = out.read()
    check(proc.returncode == 0, "cuobjdump failed: %s" % sass[-2000:])
    ops, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"flash_(fwd|bwd_dq|bwd_dkv)_f32ILi(\d+)E",
                          m.group(1))
            name = ("flash_%s_f32 d%s %s" % (
                k.group(1), k.group(2), _f32_instance(m.group(1)))
                    if k else None)
            if name:
                ops[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_.]*)?)", line)
        if name and m:
            ops[name].append(m.group(1))
    check(len(ops) == expected, "cuobjdump shows %d fp32 instances, not %d"
          % (len(ops), expected))
    report = {}
    for name, seq in ops.items():
        bad = sorted({op for op in seq if F32_FORBIDDEN.match(op)})
        check(not bad, "%s holds %s" % (name, bad))
        report[name] = {
            "instructions": len(seq),
            "ffma_share": sum(op == "FFMA" for op in seq) / len(seq),
            "lds128": sum(op == "LDS.128" for op in seq)}
    return report


def _f32_instance(entry):
    """The instance of an fp32 flash kernel from its template flags:
    "none" (no mask code), "general" (the masks as runtime flags) or, for
    the forward, "general_offset" (with pos_offset)."""
    flags = re.search(r"Li(?:64|128)ELb(\d)E(?:Lb(\d)E)?", entry).groups()
    if flags[0] == "0":
        return "none"
    return "general_offset" if flags[1] == "1" else "general"


def flash_fwd_build_report(log):
    """csrc/flash_fwd.cu's kernel instances, as flash_bwd_build_report:
    "flash_fwd_tc d<D> bf16" by mask instance ("CWSO" flags), and the
    fp32 kernel "flash_fwd_f32 d<D> fp32" by instance (_f32_instance)."""
    lib = att._flash_lib()

    def group_of(entry):
        if "flash_fwd_" not in entry:
            return None
        tc = "flash_fwd_tcI" in entry
        d = int(re.search(r"Li(64|128)E", entry).group(1))
        instance = _mask_flags(entry) if tc else _f32_instance(entry)
        return ("flash_fwd%s d%d %s" % ("_tc" if tc else "_f32", d,
                                        "bf16" if tc else "fp32"),
                instance, lib.edl_flash_fwd_smem_bytes(int(tc), d), 128)

    return _build_groups(ptxas_entries(log), group_of)


def flash_builds(report):
    """The flash_fwd and flash_bwd instances from _build.build's report
    (flash_fwd_build_report, flash_bwd_build_report), logged; fails if
    an instance spills, an fp32 forward instance keeps a stack frame, or
    a library holds other instances than it should. Returns {source:
    groups} of the sources built in this run."""
    builds = {}
    for source, reporter, n_groups, n_instances in (
            ("flash_fwd", flash_fwd_build_report, 4, 38),
            ("flash_bwd", flash_bwd_build_report, 12, 136)):
        if not report[source]["log"]:
            log("%s was built before this run: no ptxas report" % source)
            continue
        groups = builds[source] = reporter(report[source]["log"])
        for name, group in groups.items():
            log("%s: registers %s; spills %d B; stack frame %d B; shared "
                "memory %d B a block; %d blocks per SM" % (
                    name, " ".join("%s:%d" % x for x in
                                   group["registers"].items()),
                    group["spill_bytes"], group["stack_bytes"],
                    group["smem_bytes"], group["blocks_per_sm"]))
        check(len(groups) == n_groups and sum(
            len(g["registers"]) for g in groups.values()) == n_instances,
              "%s's build log names %s" % (source, sorted(groups)))
        check(not any(g["spill_bytes"] for g in groups.values()),
              "%s's kernels spill registers" % source)
        check(not any(g["stack_bytes"] for name, g in groups.items()
                      if name.startswith("flash_fwd_f32")),
              "the fp32 forward keeps a stack frame")
    return builds


def check_bwd_rounding(gen):
    """The bf16 kernels C and D beyond the paths' shapes. (1) A probe of
    P's rounding: with dO = I (l = 64 <= d), dV = P^T dO is bf16(P)^T
    exactly, so the kernel's rounded P is read back and held to the
    plain version's bf16(P), causal or not: at most a thousandth of the
    elements (those at a bf16 rounding midpoint) one bf16 unit apart,
    none further. (2) Rectangular lq != lk (200 against 136 and 333,
    GQA 4/2), d 64 and 128, causal or not, and a q view that does not
    start on 16 bytes (the wrapper copies it), against the unrounded
    plain version (BWD_TOL_REL) and the rounded one (rounded_ok); the
    first case launched twice, equal bit for
    bit. Returns a summary."""
    bf16, f32 = torch.bfloat16, torch.float32
    summary = {"probe_elements": 0, "probe_apart": 0, "probe_max_units": 0}
    for causal in (False, True):
        l, d = 64, 128
        q, k, v = flash_inputs(gen, 1, 1, 1, l, d, bf16)
        do = torch.zeros(1, 1, l, d, device="cuda", dtype=bf16)
        do[0, 0, torch.arange(l), torch.arange(l)] = 1
        out, lse = att.flash_forward(q, k, v, causal=causal)
        kw = dict(causal=causal, grad_dtype=f32)
        _dq, delta = att.flash_backward_dq(q, k, v, out, lse, do, **kw)
        _dk, dv = att.flash_backward_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        p_kernel = dv[0, 0, :, :l].t().to(bf16).contiguous()
        p_plain = att._recompute_probs(q, k, lse, causal, d ** -0.5,
                                       exp2=True)[0, 0].to(bf16).contiguous()
        # P >= 0: bf16 bit patterns count bf16 units
        units = (p_kernel.view(torch.int16).int()
                 - p_plain.view(torch.int16).int()).abs()
        summary["probe_elements"] += int((p_plain > 0).sum().item())
        summary["probe_apart"] += int((units > 0).sum().item())
        summary["probe_max_units"] = max(summary["probe_max_units"],
                                         int(units.max().item()))
    check(summary["probe_max_units"] <= 1
          and summary["probe_apart"] * 1000 <= summary["probe_elements"],
          "the bf16 backward rounds P otherwise than its plain version: %s"
          % summary)
    cases = [(d, causal, lk, False) for d in (64, 128)
             for causal in (False, True) for lk in (136, 333)]
    cases.append((128, True, 200, True))
    worst = {}
    for i, (d, causal, lk, misaligned) in enumerate(cases):
        q, _k, _v = flash_inputs(gen, 2, 4, 2, 200, d, bf16)
        do = flash_inputs(gen, 2, 4, 2, 200, d, bf16)[0]
        _q, k, v = flash_inputs(gen, 2, 4, 2, lk, d, bf16)
        if misaligned:
            flat = torch.empty(q.numel() + 1, device="cuda", dtype=bf16)
            flat[1:] = q.flatten()
            q = flat[1:].view(q.shape)
            check(q.data_ptr() % 16 != 0, "the probe view is aligned")
        out, lse = att.flash_forward(q, k, v, causal=causal)
        dq, delta = att.flash_backward_dq(q, k, v, out, lse, do,
                                          causal=causal)
        dk, dv = att.flash_backward_dkv(q, k, v, do, lse, delta,
                                        causal=causal)
        if i == 0:
            again = (att.flash_backward_dq(q, k, v, out, lse, do,
                                           causal=causal)[0],
                     *att.flash_backward_dkv(q, k, v, do, lse, delta,
                                             causal=causal))
            check(all(torch.equal(a, b)
                      for a, b in zip((dq, dk, dv), again)),
                  "the bf16 backward differs between two launches")
        torch.cuda.synchronize()
        pdq, _ = att.flash_backward_dq_plain(q, k, v, out, lse, do,
                                             causal=causal)
        pdk, pdv = att.flash_backward_dkv_plain(q, k, v, do, lse, delta,
                                                causal=causal)
        errs = rounded_bwd_errs(q, k, v, out, lse, do, causal=causal)
        errs["flash_bwd_dq"]["max_rel_err_unrounded"] = masked_rel_err(
            dq.float(), pdq.float())
        errs["flash_bwd_dkv"]["max_rel_err_unrounded"] = max(
            masked_rel_err(dk.float(), pdk.float()),
            masked_rel_err(dv.float(), pdv.float()))
        where = "lq=200 lk=%d d=%d causal=%s%s" % (
            lk, d, causal, " misaligned q" if misaligned else "")
        for name, e in errs.items():
            check(e["max_rel_err_unrounded"] <= BWD_TOL_REL[bf16]
                  and rounded_ok(e),
                  "%s disagrees with its plain versions at %s: %s"
                  % (name, where, e))
            _worst(worst, name, e)
    summary["rectangular_and_misaligned_worst"] = worst
    summary["deterministic"] = True
    log("flash bwd rounding probe and rectangular cases: %s" % summary)
    return summary


# ViT-B/16 at 224 px: 196 patches and the class token, 3 x 64 + 5 rows,
# ragged against every tile of C and D (ViT-Base's width otherwise:
# ENC_KERNEL_SHAPES["vit"])
VIT_RAGGED_L = 197
VIT_BWD_SEED = 14


def check_vit_bwd(gen):
    """The fp32 kernels C and D at ViT-Base's width (ENC_KERNEL_SHAPES
    ["vit"]: b 64, h 12, d 64, not causal): (1) at l VIT_RAGGED_L
    against their plain versions at BWD_TOL_REL (max |err| / max |ref|
    of each output); (2) at the path's l, a second launch of each on the
    same inputs (D on the first launch's delta) equal bit for bit: dq,
    delta, dk, dv. Returns {"ragged": ..., "repeat_bit_equal": ...}."""
    b, h, path_l, d, dtype = ENC_KERNEL_SHAPES["vit"]
    out = {}
    for l in (VIT_RAGGED_L, path_l):
        q, k, v = flash_inputs(gen, b, h, h, l, d, dtype)
        do = flash_inputs(gen, b, h, h, l, d, dtype)[0]
        o, lse = att.flash_forward(q, k, v, causal=False)
        dq, delta = att.flash_backward_dq(q, k, v, o, lse, do, causal=False)
        dk, dv = att.flash_backward_dkv(q, k, v, do, lse, delta,
                                        causal=False)
        torch.cuda.synchronize()
        if l == VIT_RAGGED_L:
            pdq, pdelta = att.flash_backward_dq_plain(q, k, v, o, lse, do,
                                                      causal=False)
            pdk, pdv = att.flash_backward_dkv_plain(q, k, v, do, lse, pdelta,
                                                    causal=False)
            errs = {}
            for name, pairs in (
                    ("flash_bwd_dq", ((dq, pdq), (delta, pdelta))),
                    ("flash_bwd_dkv", ((dk, pdk), (dv, pdv)))):
                check(all(torch.isfinite(a).all().item() for a, _r in pairs),
                      "%s: non-finite output at vit's width, l %d"
                      % (name, l))
                rel = max(rel_err(a, r) for a, r in pairs)
                check(rel <= BWD_TOL_REL[dtype],
                      "%s disagrees with its plain version at vit's width, "
                      "l %d: rel err %.3g" % (name, l, rel))
                errs[name] = {"max_rel_err": rel, "max_abs_err": max(
                    (a - r).abs().max().item() for a, r in pairs)}
            out["ragged"] = {"l": l, "limit_rel": BWD_TOL_REL[dtype],
                             "errors": errs}
            del pdq, pdelta, pdk, pdv
        else:
            dq2, delta2 = att.flash_backward_dq(q, k, v, o, lse, do,
                                                causal=False)
            dk2, dv2 = att.flash_backward_dkv(q, k, v, do, lse, delta,
                                              causal=False)
            torch.cuda.synchronize()
            equal = {name: torch.equal(a, a2) for name, a, a2 in (
                ("dq", dq, dq2), ("delta", delta, delta2), ("dk", dk, dk2),
                ("dv", dv, dv2))}
            check(all(equal.values()), "C and D at vit's path shape differ "
                  "between two launches: %s" % equal)
            out["repeat_bit_equal"] = dict(equal, l=l)
            del dq2, delta2, dk2, dv2
        del q, k, v, do, o, lse, dq, delta, dk, dv
    torch.cuda.empty_cache()
    log("vit's fp32 C and D: %s" % json.dumps(out))
    return out


VIT_FWD_SEED = 15


def check_vit_fwd(gen):
    """The fp32 kernel A at ViT-Base's width (ENC_KERNEL_SHAPES["vit"]:
    b 64, h 12, d 64, not causal), at l VIT_RAGGED_L and at the path's l:
    against its plain version (fwd_ok: out and lse within FWD_F32_TOL_REL
    of the plain version's largest value), and a second launch on the
    same inputs equal bit for bit. Returns {"l<l>": flash_fwd_errs's
    errors and "repeat_bit_equal"}."""
    b, h, path_l, d, dtype = ENC_KERNEL_SHAPES["vit"]
    out = {}
    for l in (VIT_RAGGED_L, path_l):
        q, k, v = flash_inputs(gen, b, h, h, l, d, dtype)
        o, lse = att.flash_forward(q, k, v, causal=False)
        o2, lse2 = att.flash_forward(q, k, v, causal=False)
        torch.cuda.synchronize()
        check(torch.isfinite(o).all().item(),
              "flash_fwd: non-finite output at vit's width, l %d" % l)
        e = flash_fwd_errs(q, k, v, o, lse, False, {})
        check(fwd_ok(e), "flash_fwd disagrees with its plain version at "
              "vit's width, l %d: %s" % (l, e))
        equal = torch.equal(o, o2) and torch.equal(lse, lse2)
        check(equal, "A at vit's width, l %d, differs between two launches"
              % l)
        out["l%d" % l] = dict(e, repeat_bit_equal=equal)
        del q, k, v, o, lse, o2, lse2
    torch.cuda.empty_cache()
    log("vit's fp32 A: %s" % json.dumps(out))
    return out


def check_autograd(gen):
    """FlashAttentionFunction's gradients on the card (forward and both
    backward kernels) against the same function on the CPU (plain
    versions), fp32 inputs, b = 2, h = 8, hkv = 2, l = 200, causal."""
    q, k, v = (x.float().cpu() for x in flash_inputs(
        gen, 2, 8, 2, 200, 128, torch.float32))
    w = torch.randn(2, 8, 200, 128, generator=gen)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [x.to(dev).requires_grad_() for x in (q, k, v)]
        out = att.flash_attention(*leaves, causal=True)
        check(type(out.grad_fn).__name__.startswith("FlashAttention"),
              "flash_attention did not record FlashAttentionFunction")
        (out * w.to(dev)).sum().backward()
        grads[dev] = [x.grad.cpu() for x in leaves]
    errs = [rel_err(a, b) for a, b in zip(grads["cuda"], grads["cpu"])]
    log("autograd cuda vs cpu (fp32): rel err dq %.3g dk %.3g dv %.3g"
        % tuple(errs))
    check(max(errs) <= BWD_TOL_REL[torch.float32],
          "FlashAttentionFunction gradients differ between the card and "
          "the CPU: %s" % errs)
    return max(errs)


def check_gather(gen, vocab=50_000):
    """Kernel E against embedding_gather_plain: dim 32 / 64 / 13, fp32
    and bf16, ids [4096] and [512, 26] drawn from [-1, vocab + 4] with
    repeats, padding ids and ids past the table. The kernel copies raw
    bits, so the outputs must be equal: max |err| 0."""
    worst = 0.0
    for dim in (32, 64, 13):
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.randn(vocab, dim, generator=gen).to("cuda", dtype)
            for shape in ((4096,), (512, 26)):
                ids = torch.randint(-1, vocab + 5, shape, generator=gen,
                                    dtype=torch.int32)
                flat = ids.view(-1)
                flat[:64] = flat[64:128]  # repeated ids
                flat[128:136] = -1
                flat[136:144] = vocab + torch.arange(8, dtype=torch.int32)
                ids = ids.cuda()
                out = eo.embedding_gather(table, ids)
                torch.cuda.synchronize()
                ref = eo.embedding_gather_plain(table, ids)
                err = (out.float() - ref.float()).abs().max().item()
                check(out.shape == ref.shape and out.dtype == ref.dtype,
                      "gather: shape/dtype %s %s vs %s %s" % (
                          tuple(out.shape), out.dtype, tuple(ref.shape),
                          ref.dtype))
                check(torch.equal(out, ref),
                      "gather kernel differs from its plain version at "
                      "dim=%d %s ids %s: max |err| %.3g"
                      % (dim, dtype, shape, err))
                worst = max(worst, err)
        log("gather dim=%d fp32/bf16, ids [4096] and [512, 26]: equal" % dim)
    return worst


# row rules of kernel F with the hyperparameters the checks and timings
# use: (wrapper arguments after the tables, ids and grads; the plain
# version's hyperparameters as the kernel takes them)
ROW_RULES = {
    "sgd": ({"lr": 0.01}, [0.01]),
    "momentum": ({"lr": 0.01, "momentum": 0.9, "nesterov": True},
                 [0.01, 0.9, 1.0]),
    "adam": ({"step": ADAM_STEP, "lr": 1e-3, "beta1": 0.9, "beta2": 0.999,
              "eps": 1e-8},
             [um.adam_alpha(1e-3, 0.9, 0.999, ADAM_STEP), 0.9, 0.999, 1e-8]),
    "adagrad": ({"lr": 0.01, "eps": 1e-10}, [0.01, 1e-10]),
}
ROW_WRAPPERS = {"sgd": eo.sparse_sgd_update,
                "momentum": eo.sparse_momentum_update,
                "adam": eo.sparse_adam_update,
                "adagrad": eo.sparse_adagrad_update}
ROW_TABLES = {"sgd": 1, "momentum": 2, "adam": 3, "adagrad": 2}


def row_inputs(gen, rule, vocab, dim, n_unique):
    """Tables (the parameter table, then the rule's slot tables: moments
    and accumulators non-negative where the rule needs it), n_unique
    unique ids in [0, vocab) mixed with 32 padding ids and 32 ids past
    the table, and their gradient rows; all on the card."""
    tables = [torch.randn(vocab, dim, generator=gen)]
    for k in range(1, ROW_TABLES[rule]):
        slot = torch.randn(vocab, dim, generator=gen) * 0.1
        tables.append(slot.abs() if rule == "adagrad" or k == 2 else slot)
    uniq = torch.randperm(vocab, generator=gen)[:n_unique].to(torch.int32)
    bad = torch.cat([torch.full((32,), -1, dtype=torch.int32),
                     vocab + torch.arange(32, dtype=torch.int32)])
    ids = torch.cat([uniq, bad])[torch.randperm(n_unique + 64,
                                                generator=gen)]
    grads = torch.randn(ids.numel(), dim, generator=gen)
    return ([t.cuda() for t in tables], ids.cuda(), grads.cuda(),
            uniq.long().cuda())


def check_row_update(gen, vocab=50_000, n_unique=4000):
    """Kernel F, each rule, against row_update_plain on the same inputs:
    dim 32 and 13, fp32. Relative error (max |err| / max |ref| per
    table) within ROW_TOL_REL; rows and slot rows the ids do not name
    must be bit-identical to their values before the call."""
    worst_abs = worst_rel = 0.0
    for dim in (32, 13):
        for rule, (kwargs, hyper) in ROW_RULES.items():
            tables, ids, grads, uniq = row_inputs(gen, rule, vocab, dim,
                                                  n_unique)
            before = [t.clone() for t in tables]
            plain = [t.clone() for t in tables]
            ROW_WRAPPERS[rule](*tables, ids, grads, **kwargs)
            torch.cuda.synchronize()
            eo.row_update_plain(rule, plain, ids, grads, hyper)
            untouched = torch.ones(vocab, dtype=torch.bool, device="cuda")
            untouched[uniq] = False
            rels = []
            for t, p, b in zip(tables, plain, before):
                check(torch.equal(t[untouched], b[untouched]),
                      "row_update %s dim=%d moved a row it was not given"
                      % (rule, dim))
                check(bool(torch.isfinite(t).all()),
                      "row_update %s: non-finite" % rule)
                rels.append(rel_err(t, p))
                worst_abs = max(worst_abs, (t - p).abs().max().item())
            log("row_update %s dim=%d: rel err %s, untouched rows equal"
                % (rule, dim, ["%.3g" % r for r in rels]))
            check(max(rels) <= ROW_TOL_REL,
                  "row_update %s dim=%d disagrees with its plain version: "
                  "%s" % (rule, dim, rels))
            worst_rel = max(worst_rel, max(rels))
    return worst_abs, worst_rel


def grouped_hyper(rule, t, n_tab):
    """Table t's hyperparameters for the grouped row update, as the
    kernel takes them: its own learning rate and, for Adam, its own
    update count, so that a mix-up of the tables' descriptors shows."""
    kwargs, _hyper = ROW_RULES[rule]
    lr = kwargs["lr"] * (1.0 + t / n_tab)
    if rule == "sgd":
        return [lr]
    if rule == "momentum":
        return [lr, kwargs["momentum"], float(t % 2)]  # nesterov on odd t
    if rule == "adam":
        return [um.adam_alpha(lr, kwargs["beta1"], kwargs["beta2"], 1 + t),
                kwargs["beta1"], kwargs["beta2"], kwargs["eps"]]
    return [lr, kwargs["eps"]]


def _off_alignment(x):
    """A copy of x whose data starts one element past a 16-byte boundary
    (4 bytes off for fp32, 2 for bf16): the kernels' scalar path."""
    flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    view = flat[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def _grouped_launches(name, before, n_nonempty):
    got = eo.KERNEL_LAUNCHES[name] - before
    want = -(-n_nonempty // eo.GROUP_TABLES)
    check(got == want, "%s launched %d times for %d tables with ids, not %d"
          % (name, got, n_nonempty, want))


def check_grouped_sweep(gen):
    """The grouped wrappers of E and F (one launch for up to
    GROUP_TABLES tables) against their plain versions, at small shapes:
    dims 13 (the scalar path), 32, 40 (10 16-byte units a row) and 64;
    5 tables and GROUP_TABLES + 3 (two launches); vocabs 1 to 3000 in
    one group; a table with no ids; ids of -1 and past the table; table
    0 one element off 16-byte alignment (the scalar path for the whole
    launch) or not. E: fp32 and bf16, ids as a list and as one [T, n]
    tensor, equal bit for bit. F: each rule, each table its own
    learning rate and count (grouped_hyper), unique ids mixed with -1
    and ids past the table; within ROW_TOL_REL per table, and rows the
    ids do not name equal to the plain version's, which leaves them as
    they were. Returns (E's max |err|, F's max relative err, cases)."""
    worst_gather = worst_row = 0.0
    cases = 0
    for dim, n_tab, misalign in itertools.product(
            (13, 32, 40, 64), (5, eo.GROUP_TABLES + 3), (False, True)):
        vocabs = torch.randint(1, 3000, (n_tab,), generator=gen).tolist()
        vocabs[0] = 1
        counts = torch.randint(1, 300, (n_tab,), generator=gen).tolist()
        counts[1] = 0
        for dtype in (torch.float32, torch.bfloat16):
            tables = [torch.randn(v, dim, generator=gen).to("cuda", dtype)
                      for v in vocabs]
            if misalign:
                tables[0] = _off_alignment(tables[0])
            ids = [torch.randint(-2, v + 3, (k,), generator=gen,
                                 dtype=torch.int32).cuda()
                   for v, k in zip(vocabs, counts)]
            matrix = torch.randint(-1, min(vocabs) + 2, (n_tab, 64),
                                   generator=gen, dtype=torch.int32).cuda()
            for form, nonempty in ((ids, n_tab - 1), (matrix, n_tab)):
                before = eo.KERNEL_LAUNCHES["embedding_gather_many"]
                out = eo.embedding_gather_many(tables, form)
                torch.cuda.synchronize()
                _grouped_launches("embedding_gather_many", before, nonempty)
                for t, (o, r) in enumerate(zip(
                        out, eo.embedding_gather_many_plain(tables, form))):
                    err = ((o.float() - r.float()).abs().max().item()
                           if o.numel() else 0.0)
                    check(o.shape == r.shape and torch.equal(o, r),
                          "grouped gather differs from its plain version: "
                          "table %d of %d, dim %d %s%s, max |err| %.3g"
                          % (t, n_tab, dim, dtype, " misaligned"
                             if misalign else "", err))
                    worst_gather = max(worst_gather, err)
                cases += 1
        for rule in ROW_RULES:
            groups, uniq, grads, hypers = [], [], [], []
            for t, (v, k) in enumerate(zip(vocabs, counts)):
                group = [torch.randn(v, dim, generator=gen)]
                for j in range(1, ROW_TABLES[rule]):
                    slot = torch.randn(v, dim, generator=gen) * 0.1
                    group.append(slot.abs() if rule == "adagrad" or j == 2
                                 else slot)
                groups.append([x.cuda() for x in group])
                u = torch.randperm(v, generator=gen)[:k].to(torch.int32)
                if k:
                    u = torch.cat([u, torch.tensor([-1, v, v + 7],
                                                   dtype=torch.int32)])
                uniq.append(u[torch.randperm(u.numel(), generator=gen)]
                            .cuda())
                grads.append(torch.randn(u.numel(), dim, generator=gen)
                             .cuda())
                hypers.append(grouped_hyper(rule, t, n_tab))
            if misalign:
                groups[0][0] = _off_alignment(groups[0][0])
            mine = [[x.clone() for x in g] for g in groups]
            if misalign:
                mine[0][0] = _off_alignment(mine[0][0])
            before = eo.KERNEL_LAUNCHES["row_update_many"]
            eo.row_update_many(rule, mine, uniq, grads, hypers)
            torch.cuda.synchronize()
            _grouped_launches("row_update_many", before, n_tab - 1)
            eo.row_update_many_plain(rule, groups, uniq, grads, hypers)
            for t, (got, ref, u) in enumerate(zip(mine, groups, uniq)):
                untouched = torch.ones(vocabs[t], dtype=torch.bool,
                                       device="cuda")
                untouched[u[(u >= 0) & (u < vocabs[t])].long()] = False
                for x, y in zip(got, ref):
                    check(torch.equal(x[untouched], y[untouched]),
                          "grouped row_update %s moved a row it was not "
                          "given: table %d of %d, dim %d" % (
                              rule, t, n_tab, dim))
                    rel = rel_err(x, y)
                    check(rel <= ROW_TOL_REL, "grouped row_update %s "
                          "differs from its plain version: table %d of %d, "
                          "dim %d%s, rel err %.3g" % (
                              rule, t, n_tab, dim, " misaligned"
                              if misalign else "", rel))
                    worst_row = max(worst_row, rel)
            cases += 1
    log("grouped gather / row_update sweep: %d cases, gather max |err| "
        "%.3g, row_update max rel err %.3g" % (cases, worst_gather,
                                               worst_row))
    return worst_gather, worst_row, cases


# ------------------------------------------------------------ serving slice


def serving_specs(rng):
    """The 16-request mix: (prompt, max_new_tokens), prompts of 32-512
    tokens, 8 of them sharing a 256-token prefix, 32-128 new tokens."""
    vocab = FLAGSHIP["vocab_size"]
    prefix = rng.randint(0, vocab, size=256).tolist()
    specs = []
    for i in range(16):
        p_len = int(rng.randint(32, 513))
        new = int(rng.randint(32, 129))
        if i % 2 == 0:
            p_len = max(p_len, 264)
            prompt = prefix + rng.randint(0, vocab,
                                          size=p_len - 256).tolist()
        else:
            prompt = rng.randint(0, vocab, size=p_len).tolist()
        specs.append((prompt, new))
    return specs


def serving_kernels(kv_cache_dtype="", attn_window=0):
    """The kernel variants the serving path launches: flash forward
    (prefill) and the paged split and tile kernels, int8 or float, with
    their window variants under a sliding window."""
    names = SERVING_INT8_KERNELS if kv_cache_dtype else SERVING_KERNELS
    return tuple(n + "_window" for n in names) if attn_window else names


def serve_flagship(specs, kv_cache_dtype="", attn_window=0,
                   streams_out=None):
    """Greedy requests `specs` through the port's server at flagship
    width (the paged pool), the KV arenas in the compute dtype or int8,
    every layer sliding-window attention when `attn_window` is set.
    Returns the serving metrics and the kernel launch counts of the run;
    the generated tokens go to `streams_out` when it is a list."""
    model = TransformerLM(device="cuda", seed=0,
                          kv_cache_dtype=kv_cache_dtype,
                          attn_window=attn_window, **FLAGSHIP)
    server = GenerationServer(model, ServingConfig(
        num_slots=8, queue_capacity=64, kv_paged=True, kv_block_size=16,
        kv_shared=True,
    )).start()
    kernels = serving_kernels(kv_cache_dtype, attn_window)
    try:
        # warm the card (cuBLAS handles, allocator) outside the counts
        server.generate([1, 2, 3, 4], 2)
        vocab = FLAGSHIP["vocab_size"]
        sched = server.scheduler
        n_steps, n_ttft = len(sched.step_secs), len(sched.ttft_secs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        att.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = [server.submit(p, n) for p, n in specs]
        for req in reqs:
            for _chunk in server.events(req):
                pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(att.KERNEL_LAUNCHES)
        if streams_out is not None:
            streams_out.extend(list(r.generated) for r in reqs)
        for req, (prompt, new) in zip(reqs, specs):
            check(len(req.generated) == new,
                  "request %d finished with %d of %d tokens"
                  % (req.request_id, len(req.generated), new))
            check(all(0 <= t < vocab for t in req.generated),
                  "token out of the vocabulary")
        kv = server.status()
        check(kv["kv_cache_dtype"] == kv_cache_dtype,
              "the server reports kv_cache_dtype %r, not %r"
              % (kv["kv_cache_dtype"], kv_cache_dtype))
        ttft = np.asarray(sched.ttft_secs[n_ttft:]) * 1e3
        steps = np.asarray(sched.step_secs[n_steps:]) * 1e3
        tokens = sum(len(r.generated) for r in reqs)
        metrics = {
            "requests": len(reqs),
            "tokens_generated": tokens,
            "prompt_tokens": sum(len(p) for p, _n in specs),
            "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99)),
            "decode_step_ms_p50": float(np.percentile(steps, 50)),
            "decode_step_ms_p99": float(np.percentile(steps, 99)),
            "decode_steps": int(steps.size),
            "mean_batch": float(np.mean(sched.step_batch[n_steps:])),
            "peak_memory_bytes": int(torch.cuda.max_memory_allocated()),
            "prefix_hit_tokens": kv["prefix_hit_tokens"],
            "kv_cache_dtype": kv["kv_cache_dtype"],
            "kv_blocks_total": kv["kv_blocks_total"],
            "kv_bytes_total": kv["kv_bytes_total"],
            "kv_block_bytes": server.engine.kv.block_bytes,
        }
    finally:
        server.stop(timeout=120)
    check(not server.scheduler.is_alive(), "scheduler did not stop")
    check(server.scheduler.crashed is None,
          "scheduler crashed: %r" % (server.scheduler.crashed,))
    for name in kernels:
        check(launches[name] > 0,
              "kernel %s was not launched on the serving path" % name)
    every = {n for kv in ("", "int8") for w in (0, 1)
             for n in serving_kernels(kv, w)}
    for name in every - set(kernels):
        check(launches[name] == 0,
              "kernel %s was launched on the %s%s serving path"
              % (name, kv_cache_dtype or "bf16",
                 " windowed" if attn_window else ""))
    return metrics, launches


def numpy_flax_params(cfg, seed):
    """transformer_lm params in the flax layout, drawn by numpy."""
    rs = np.random.RandomState(seed)
    e, v = cfg["embed_dim"], cfg["vocab_size"]

    def w(*shape):
        return (rs.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)

    def vec(n, base):
        return (base + 0.1 * rs.standard_normal(n)).astype(np.float32)

    params = {"wte/embedding": w(v, e) * np.sqrt(v / e),
              "wpe/embedding": w(cfg["seq_len"], e),
              "ln_f/scale": vec(e, 1.0), "ln_f/bias": vec(e, 0.0),
              "head/kernel": w(e, v)}
    for i in range(cfg["num_layers"]):
        blk = "block_%d/" % i
        params.update({
            blk + "LayerNorm_0/scale": vec(e, 1.0),
            blk + "LayerNorm_0/bias": vec(e, 0.0),
            blk + "LayerNorm_1/scale": vec(e, 1.0),
            blk + "LayerNorm_1/bias": vec(e, 0.0),
            blk + "attn/qkv/kernel": w(e, 3 * e),
            blk + "attn/proj/kernel": w(e, e),
            blk + "mlp_up/kernel": w(e, 4 * e),
            blk + "mlp_up/bias": vec(4 * e, 0.0),
            blk + "mlp_down/kernel": w(4 * e, e),
            blk + "mlp_down/bias": vec(e, 0.0),
        })
    return params


def logits_trace(model, prompt, forced):
    """Prefill logits [p, vocab] and the logits of len(forced) paged
    decode steps fed `forced` tokens (None: the step's own argmax),
    through the serving pool's write paths. Returns (prefill, decode
    logits, tokens fed, each layer's prefill k rows)."""
    dev = model.device
    pool = PagedKVPool(kv_layout(model), model.seq_len, 1, 64, 16,
                       device=dev)
    p = len(prompt)
    pool.seat(0, prompt, p + len(forced))
    logits, kv = model(torch.as_tensor([prompt], device=dev))
    pool.write_prompt(kv, 0, p)
    fed, steps = [], []
    nxt = int(logits[0, -1].argmax())
    for i, tok in enumerate(forced):
        tok = nxt if tok is None else tok
        fed.append(tok)
        pos = p + i
        pool.ensure_blocks(0, pos)
        step, rows = model.decode_paged(
            torch.as_tensor([[tok]], device=dev),
            torch.as_tensor([pos], device=dev), pool.pools,
            pool.tables_device())
        pool.scatter([tuple(leaf[:, :, 0] for leaf in layer)
                      for layer in rows],
                     [pool.tables[0, pos // 16]], [pos % 16])
        steps.append(step[0, 0])
        nxt = int(step[0, 0].argmax())
    steps = (torch.stack(steps) if steps
             else logits.new_zeros((0, logits.shape[-1])))
    return (logits[0].float().cpu(), steps.float().cpu(), fed,
            [layer[0].cpu() for layer in kv])


def compare_cuda_cpu(rng):
    """A 2-layer flagship-width model on the card and on the CPU, same
    numpy weights, bf16 on both: prefill and 8 decode steps fed the
    card's greedy tokens."""
    cfg = dict(FLAGSHIP, num_layers=2)
    sd = params_from_flax(numpy_flax_params(cfg, seed=1))
    prompt = rng.randint(0, cfg["vocab_size"], size=64).tolist()
    runs = {}
    forced = [None] * 8
    for dev in ("cuda", "cpu"):
        model = TransformerLM(device=dev, **cfg)
        model.load_state_dict(sd)
        model.use_compute_weights()
        runs[dev] = logits_trace(model, prompt, forced)
        forced = runs[dev][2]
    out = {}
    for i, what in enumerate(("prefill", "decode")):
        gpu, cpu = runs["cuda"][i], runs["cpu"][i]
        scale = cpu.abs().max().item()
        err = (gpu - cpu).abs().max().item()
        log("cuda vs cpu %s logits: max err %.4g, max |logit| %.4g"
            % (what, err, scale))
        check(bool(torch.isfinite(gpu).all()), "non-finite %s logits" % what)
        check(err <= LOGIT_TOL_REL * scale,
              "%s logits: cuda and cpu differ by %.4g (limit %.4g)"
              % (what, err, LOGIT_TOL_REL * scale))
        out[what] = {"max_abs_err": err, "max_abs_logit": scale}
    return out


def compare_cuda_cpu_int8(rng):
    """A small int8-cache model (vocab 4096, embed 256, 2 heads of 128, 2
    layers, fp32, numpy weights) on the card and on the CPU: prefill of a
    64-token prompt and 8 decode steps fed the card's greedy tokens,
    through the int8 paged kernels on the card and their plain versions
    on the CPU.

    Each quantizer call of the CPU run returns the card's int8 rows and
    scales for that call, so both runs attend over the same int8 values
    and the logits compare the int8 path's arithmetic. The CPU's own
    quantization of its fp32 rows is held beside the card's: no element
    more than one step apart (one step where fp32 rounding on the two
    devices puts a value on either side of a .5; counted), scales within
    INT8_SCALE_TOL_REL. The same model with an fp32 cache runs on both
    devices too, as the baseline of the logits' error."""
    cfg = dict(vocab_size=4096, seq_len=256, embed_dim=256, num_heads=2,
               num_layers=2)
    sd = params_from_flax(numpy_flax_params(cfg, seed=7))
    prompt = rng.randint(0, cfg["vocab_size"], size=64).tolist()
    quantize = tzoo.kv_quantize_rows
    card_rows, cpu_rows = [], []

    def on_card(rows):
        card_rows.append(quantize(rows))
        return card_rows[-1]

    def on_cpu(rows):
        cpu_rows.append(quantize(rows))
        return tuple(t.cpu() for t in card_rows[len(cpu_rows) - 1])

    runs = {}
    for kv_dtype in ("", "int8"):
        forced = [None] * 8
        for dev, hook in (("cuda", on_card), ("cpu", on_cpu)):
            model = TransformerLM(device=dev, kv_cache_dtype=kv_dtype, **cfg)
            model.load_state_dict(sd)
            tzoo.kv_quantize_rows = hook
            try:
                runs[kv_dtype, dev] = logits_trace(model, prompt, forced)
            finally:
                tzoo.kv_quantize_rows = quantize
            forced = runs[kv_dtype, dev][2]
    check(len(card_rows) == len(cpu_rows) == 2 * cfg["num_layers"] * 9,
          "int8 model: %d quantizer calls on the card, %d on the CPU"
          % (len(card_rows), len(cpu_rows)))
    flips = steps = 0
    scale_err = 0.0
    for (q_card, s_card), (q_cpu, s_cpu) in zip(card_rows, cpu_rows):
        diff = (q_card.cpu().int() - q_cpu.int()).abs()
        steps = max(steps, int(diff.max()))
        flips += int((diff > 0).sum())
        scale_err = max(scale_err, rel_err(s_card.cpu(), s_cpu))
    out = {"quantized_elements_one_step_apart": flips,
           "quantized_max_steps_apart": steps,
           "scale_max_rel_err": scale_err}
    log("int8 quantizer card vs cpu: %d elements one step apart (max %d "
        "steps), scales rel err %.3g" % (flips, steps, scale_err))
    check(steps <= 1 and scale_err <= INT8_SCALE_TOL_REL,
          "int8 quantizer: card and cpu rows %d steps apart, scales rel err "
          "%.3g" % (steps, scale_err))
    for i, what in enumerate(("prefill", "decode")):
        for kv_dtype in ("", "int8"):
            gpu, cpu = runs[kv_dtype, "cuda"][i], runs[kv_dtype, "cpu"][i]
            scale = cpu.abs().max().item()
            err = (gpu - cpu).abs().max().item()
            log("%s-cache model cuda vs cpu %s logits (fp32): max err %.4g, "
                "max |logit| %.4g" % (kv_dtype or "fp32", what, err, scale))
            check(bool(torch.isfinite(gpu).all()),
                  "non-finite %s logits" % what)
            check(err <= INT8_LOGIT_TOL_REL * scale,
                  "%s-cache %s logits: cuda and cpu differ by %.4g (limit "
                  "%.4g)" % (kv_dtype or "fp32", what, err,
                             INT8_LOGIT_TOL_REL * scale))
            key = what if kv_dtype else what + "_fp32_cache"
            out[key] = {"max_abs_err": err, "max_abs_logit": scale,
                        "limit_rel": INT8_LOGIT_TOL_REL}
    return out


def _device_us(event):
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def device_summary(events, steps, step_ms, top, group=None):
    """Device time per step from a profiler's key_averages: the sum of
    the kernels' own time (events on the CUDA device; operator ranges,
    which report their kernels' time again, and user annotations such as
    `Optimizer.step`, which report the span of theirs, are left out), its
    share of `step_ms` (the step on the host clock, measured without the
    profiler, which slows the host but not the kernels), the `top`
    kernels, and the time of the kernels whose name contains `group`."""
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3 / steps
    ranked = sorted(kernels, key=_device_us, reverse=True)
    out = {
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / step_ms,
        "kernel_ms_per_step": {
            e.key[:60]: _device_us(e) / 1e3 / steps for e in ranked[:top]},
    }
    if group:
        ms = sum(_device_us(e) for e in kernels
                 if group in e.key) / 1e3 / steps
        out["%s_kernels_ms_per_step" % group.strip("_")] = ms
        out["%s_kernels_share_of_device" % group.strip("_")] = (
            ms / device_ms if device_ms else None)
    return out


def profile_decode(rng, steps=10, kv_cache_dtype="", dense=False):
    """Where a decode step's time goes: the flagship engine (KV arenas in
    the compute dtype, or int8; the paged engine, or the dense one) with
    8 active slots, `steps` steps timed on the host clock, then the same
    number under torch.profiler for the device's busy time and the top
    host and device entries."""
    from torch.profiler import ProfilerActivity, profile

    from elasticdl_tpu_torch.serving.admission import ServingRequest
    from elasticdl_tpu_torch.serving.engine import (
        ContinuousBatchingEngine,
        PagedContinuousBatchingEngine,
    )

    model = TransformerLM(device="cuda", seed=0,
                          kv_cache_dtype=kv_cache_dtype, **FLAGSHIP)
    engine = (ContinuousBatchingEngine(model, 8) if dense else
              PagedContinuousBatchingEngine(model, 8, block_size=16))
    for _ in range(8):
        engine.insert(ServingRequest(
            rng.randint(0, FLAGSHIP["vocab_size"], size=256).tolist(),
            4 * steps + 8))
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:8]
    return {
        "batch": 8, "kv_cache_dtype": kv_cache_dtype,
        "engine": "dense" if dense else "paged", "step_ms": step_ms,
        "step_ms_profiled": prof_ms,
        **device_summary(events, steps, step_ms, top=6),
        "top_host_ms_per_step": {
            e.key[:60]: e.self_cpu_time_total / 1e3 / steps
            for e in top_cpu},
        "host_ops_per_step": sum(e.count for e in events
                                 if e.key.startswith("aten::")) / steps,
    }


# ----------------------------------------------------------- training slice


def transformer_flops_per_step(batch, seq, d_model, n_layers, vocab):
    """Matmul operations of one forward + backward train step, bench.py's
    count: per token and layer 24 d^2 (qkv, proj, MLP) + 4 seq d
    (attention scores and values), plus 2 d vocab for the head; the
    backward is twice the forward."""
    per_token_layer = 24 * d_model * d_model + 4 * seq * d_model
    fwd = batch * seq * (n_layers * per_token_layer + 2 * d_model * vocab)
    return 3 * fwd


def _params_str(cfg):
    kw = dict(cfg, dtype="bf16")
    return "; ".join("%s=%r" % kv for kv in kw.items())


def _write_token_records(path, n, rng):
    """n records of seq_len + 1 tokens, as the zoo's dataset_fn reads
    them, through the port's own writer."""
    length = FLAGSHIP["seq_len"] + 1
    with RecordWriter(path) as w:
        for _ in range(n):
            w.write(encode_example({"tokens": rng.randint(
                0, FLAGSHIP["vocab_size"], size=(length,)).astype(np.int64)}))


def train_flagship(rng, workdir, attn_window=0):
    """TRAIN_STEPS steps of the flagship model (sliding-window attention
    when `attn_window` is set) through LocalExecutor (minibatch
    TRAIN_BATCH) over token records on disk. Returns the training
    metrics, the executor and the kernel launches of the run."""
    data = os.path.join(workdir, "train")
    os.makedirs(data)
    _write_token_records(os.path.join(data, "tokens-00000.trec"),
                         TRAIN_BATCH * TRAIN_STEPS + 3, rng)
    cfg = dict(FLAGSHIP, attn_window=attn_window) if attn_window else FLAGSHIP
    kernels = tuple(n + "_window" if attn_window else n
                    for n in TRAINING_KERNELS)
    executor = LocalExecutor(
        load_model_spec_from_module(tzoo), training_data=data,
        minibatch_size=TRAIN_BATCH, max_steps=TRAIN_STEPS,
        model_params=_params_str(cfg), device="cuda")
    steps = []
    step_fn = executor.trainer.train_step

    def timed_step(state, batch, true_count=None):
        before = dict(att.KERNEL_LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(state, batch, true_count)
        torch.cuda.synchronize()
        steps.append({
            "ms": (time.perf_counter() - t0) * 1e3,
            "launches": {k: att.KERNEL_LAUNCHES[k] - before[k]
                         for k in att.KERNEL_LAUNCHES},
        })
        return out

    executor.trainer.train_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    att.reset_launch_counts()
    t0 = time.perf_counter()
    state, _metrics = executor.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(att.KERNEL_LAUNCHES)
    # drop the wrapper (an instance attribute): assigning the bound
    # method back would make a reference cycle that keeps the model and
    # its optimizer slots alive after the caller lets go of them
    del executor.trainer.train_step
    losses = executor.losses
    log("training losses: %s; step ms %s" % (
        losses, [round(s["ms"], 2) for s in steps]))
    check(state is not None and state.step == TRAIN_STEPS
          and len(losses) == TRAIN_STEPS,
          "LocalExecutor took %d steps, not %d" % (len(losses), TRAIN_STEPS))
    check(all(math.isfinite(x) for x in losses), "non-finite training loss")
    # at initialisation the head's logits have unit variance (lecun-normal
    # kernel over a LayerNorm output), so the expected first loss is
    # ln(vocab) + 1/2, not ln(vocab)
    expected = math.log(FLAGSHIP["vocab_size"]) + 0.5
    check(abs(losses[0] - expected) <= 0.5,
          "first loss %.4f is not within 0.5 of ln(%d) + 1/2 = %.4f"
          % (losses[0], FLAGSHIP["vocab_size"], expected))
    layers = FLAGSHIP["num_layers"]
    for i, s in enumerate(steps):
        for name, count in s["launches"].items():
            want = layers if name in kernels else 0
            check(count == want,
                  "step %d launched %s %d times, not %d" % (i, name, count,
                                                            want))
    timed = np.asarray([s["ms"] for s in steps[1:]])
    step_ms = float(np.percentile(timed, 50))
    tokens = TRAIN_BATCH * FLAGSHIP["seq_len"]
    flops = transformer_flops_per_step(
        TRAIN_BATCH, FLAGSHIP["seq_len"], FLAGSHIP["embed_dim"], layers,
        FLAGSHIP["vocab_size"])
    metrics = {
        "model": "transformer_lm flagship, bf16 compute, fp32 params"
                 + (", attn_window %d" % attn_window if attn_window else ""),
        "minibatch": TRAIN_BATCH, "seq_len": FLAGSHIP["seq_len"],
        "steps": TRAIN_STEPS,
        "step_ms": [s["ms"] for s in steps],
        "step_ms_p50": step_ms,
        "step_ms_p50_over": "steps 2-%d (step 1 warms the card)"
                            % TRAIN_STEPS,
        "tokens_per_s": tokens / (step_ms / 1e3),
        "mfu": flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
        "flops_per_step": flops,
        "peak_memory_bytes": int(torch.cuda.max_memory_allocated()),
        "losses": losses, "expected_first_loss": expected,
        "wall_s": wall,
        "launches_per_step": {k: steps[-1]["launches"][k] for k in kernels},
    }
    return metrics, executor, launches


def compare_train_step(rng):
    """One bf16 train_step of a 2-layer flagship-width model on the card
    and on the CPU (plain versions), same numpy weights and batch: the
    loss and every parameter's gradient norm, by relative error."""
    cfg = {k: v for k, v in FLAGSHIP.items() if k != "dtype"}
    cfg["num_layers"] = 2
    sd = params_from_flax(numpy_flax_params(cfg, seed=3))
    tokens = rng.randint(0, cfg["vocab_size"],
                         size=(2, cfg["seq_len"] + 1)).astype(np.int32)
    batch = ({"tokens": tokens[:, :-1]}, tokens[:, 1:])
    runs = {}
    for dev in ("cuda", "cpu"):
        spec = load_model_spec_from_module(tzoo)
        trainer = Trainer(spec, model_params=_params_str(cfg), device=dev)
        state = trainer.init_state(batch, params=sd)
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        secs = time.perf_counter() - t0
        norms = {k: p.grad.float().norm().item()
                 for k, p in state.params.items()}
        runs[dev] = (loss, norms, secs)
    (gl, gn, gs), (cl, cn, cs) = runs["cuda"], runs["cpu"]
    loss_err = abs(gl - cl) / abs(cl)
    norm_errs = {k: abs(gn[k] - cn[k]) / max(cn[k], 1e-30) for k in cn}
    worst = max(norm_errs, key=norm_errs.get)
    log("train step cuda vs cpu: loss %.6f / %.6f (rel %.3g); worst grad "
        "norm rel err %.3g (%s); %.1f s / %.1f s"
        % (gl, cl, loss_err, norm_errs[worst], worst, gs, cs))
    check(all(math.isfinite(x) for x in list(gn.values()) + [gl]),
          "non-finite loss or gradient on the card")
    check(loss_err <= STEP_LOSS_TOL_REL,
          "train step loss: card %.6f vs cpu %.6f" % (gl, cl))
    check(norm_errs[worst] <= STEP_GRAD_NORM_TOL_REL,
          "gradient norm of %s: card %.6g vs cpu %.6g"
          % (worst, gn[worst], cn[worst]))
    return {"loss_cuda": gl, "loss_cpu": cl, "loss_rel_err": loss_err,
            "grad_norm_max_rel_err": norm_errs[worst],
            "grad_norm_worst_param": worst,
            "limits": {"loss_rel": STEP_LOSS_TOL_REL,
                       "grad_norm_rel": STEP_GRAD_NORM_TOL_REL}}


def profile_train_step(executor, rng, steps=2):
    """Where a flagship training step's time goes: after one warm step,
    `steps` more steps of the executor's trainer on one batch timed on
    the host clock, then as many under torch.profiler."""
    tokens = rng.randint(0, FLAGSHIP["vocab_size"], size=(
        TRAIN_BATCH, FLAGSHIP["seq_len"] + 1)).astype(np.int32)
    batch = ({"tokens": tokens[:, :-1]}, tokens[:, 1:])
    return profile_steps(executor.trainer, executor.state, batch, steps)


def profile_steps(trainer, state, batch, steps=2):
    """One warm train_step on `batch`, `steps` more timed on the host
    clock, then as many under torch.profiler: the step's device time by
    kernel and its busy share."""
    from torch.profiler import ProfilerActivity, profile

    state, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    return {"step_ms": step_ms, "step_ms_profiled": prof_ms,
            **device_summary(events, steps, step_ms, top=10, group="flash_"),
            "host_ops_per_step": sum(e.count for e in events
                                     if e.key.startswith("aten::")) / steps}


# -------------------------------------------------------------- DLRM slice


def _dlrm_params_str(cfg):
    return "; ".join("%s=%r" % kv for kv in cfg.items())


def _write_criteo_records(path, n, rng):
    """n Criteo-like records (numeric I1..I13, categorical strings
    C1..C26, a binary label, as the JAX package's gen_criteo_like writes
    them) through the port's writer. Returns the C1 strings' hashed ids,
    the rows of table 0 these records touch."""
    c1 = set()
    with RecordWriter(path) as w:
        for _ in range(n):
            ex = {"I%d" % i: np.array(rng.rand() * 100, dtype=np.float32)
                  for i in range(1, 14)}
            for i in range(1, 27):
                ex["C%d" % i] = np.array(
                    ("cat%d" % rng.randint(1000)).encode(), dtype="S16")
            ex["label"] = np.array(rng.randint(2), dtype=np.int64)
            c1.add(string_to_id(ex["C1"].item().decode(), dzoo.HASH_BUCKETS))
            w.write(encode_example(ex))
    return sorted(c1)


def reset_all_launch_counts():
    att.reset_launch_counts()
    eo.reset_launch_counts()


def all_launch_counts():
    return dict(att.KERNEL_LAUNCHES, **eo.KERNEL_LAUNCHES)


def train_dlrm(rng, workdir):
    """DLRM_STEPS steps of the bench-width DLRM through LocalExecutor
    (minibatch DLRM_BATCH, SGD 0.01) over Criteo-like records on disk,
    then one evaluation over DLRM_BATCH validation records. Returns the
    metrics, the executor and the kernel launches of the run."""
    train, valid = (os.path.join(workdir, d) for d in ("dtrain", "dvalid"))
    os.makedirs(train)
    os.makedirs(valid)
    t0 = time.perf_counter()
    touched = _write_criteo_records(os.path.join(train, "c-00000.trec"),
                                    DLRM_BATCH * DLRM_STEPS, rng)
    _write_criteo_records(os.path.join(valid, "c-00000.trec"), DLRM_BATCH,
                          rng)
    write_s = time.perf_counter() - t0
    executor = LocalExecutor(
        load_model_spec_from_module(dzoo), training_data=train,
        validation_data=valid, minibatch_size=DLRM_BATCH,
        records_per_task=DLRM_BATCH * DLRM_STEPS, max_steps=DLRM_STEPS,
        model_params=_dlrm_params_str(DLRM), device="cuda")
    trainer = executor.trainer
    table0 = trainer.model.table_0.embedding_table
    touched = np.unique(np.asarray(touched) % DLRM["table_size"])
    untouched = np.setdiff1d(rng.randint(0, DLRM["table_size"], 256),
                             touched)[:64]
    touched = rng.choice(touched, 64, replace=False)
    before = {"touched": table0[touched].clone(),
              "untouched": table0[untouched].clone()}
    # the first loss at initialisation, from the first batch the run will
    # take (its one task covers every record; dataset_fn's shuffle is
    # seeded): the cross entropy of a logit z and a label y is ln 2 +
    # log cosh(z/2) + (1/2 - y) z, and the labels are fair coins
    # independent of z, so the batch mean is ln 2 + mean(log cosh(z/2))
    # up to the mean of (1/2 - y) z, whose stddev is sqrt(mean(z^2) / n)
    # / 2: the check allows five of those. This forward runs before the
    # counts are reset.
    reader = executor._reader(train)
    (shard, (start, count)), = reader.create_shards().items()
    task = Task(shard, start, start + count, TaskType.TRAINING)
    for first_batch in executor._task_dataset(reader, task, Mode.TRAINING):
        break
    first_batch, _ = pad_batch(first_batch, DLRM_BATCH)
    z = trainer.forward(None, first_batch[0])["logits"].double()
    first = math.log(2) + float((torch.logaddexp(z / 2, -z / 2)
                                 - math.log(2)).mean())
    first_tol = 2.5 * math.sqrt(float((z * z).mean()) / z.numel())
    steps = []
    step_fn = trainer.train_step

    def timed_step(state, batch, true_count=None):
        if not steps:
            check(np.array_equal(batch[1], first_batch[1])
                  and np.array_equal(batch[0]["sparse"],
                                     first_batch[0]["sparse"]),
                  "the DLRM run's first batch is not the one its expected "
                  "first loss was computed from")
        before_counts = all_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(state, batch, true_count)
        torch.cuda.synchronize()
        after = all_launch_counts()
        steps.append({
            "ms": (time.perf_counter() - t0) * 1e3,
            "launches": {k: after[k] - before_counts[k]
                         for k in DLRM_KERNELS + DLRM_TABLE_KERNELS}})
        return out

    trainer.train_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    t0 = time.perf_counter()
    state, metrics = executor.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launch_counts()
    del trainer.train_step  # as in train_flagship
    losses = executor.losses
    log("dlrm losses: %s; step ms %s; eval %s" % (
        losses, [round(s["ms"], 2) for s in steps], metrics))
    check(state is not None and state.step == DLRM_STEPS
          and len(losses) == DLRM_STEPS,
          "DLRM LocalExecutor took %d steps, not %d"
          % (len(losses), DLRM_STEPS))
    check(all(math.isfinite(x) for x in losses), "non-finite DLRM loss")
    check(abs(losses[0] - first) <= first_tol,
          "first DLRM loss %.5f is not within %.4f of its expectation at "
          "initialisation %.5f" % (losses[0], first_tol, first))
    for i, s in enumerate(steps):
        want = dict.fromkeys(DLRM_KERNELS, 1)
        want.update(dict.fromkeys(DLRM_TABLE_KERNELS, 0))
        check(s["launches"] == want, "DLRM step %d launched %s, not one "
              "grouped launch each of E and F for the %d tables" % (
                  i, s["launches"], DLRM["num_tables"]))
    eval_launches = {k: launches[k] - sum(s["launches"][k] for s in steps)
                     for k in DLRM_KERNELS + DLRM_TABLE_KERNELS}
    check(eval_launches == {"embedding_gather_many": 1, "row_update_many": 0,
                            "embedding_gather": 0, "row_update": 0},
          "the DLRM evaluation launched %s, not one grouped gather"
          % eval_launches)
    moved = (table0[touched] != before["touched"]).any(dim=1)
    check(bool(moved.all()), "%d of 64 touched rows of table 0 did not move"
          % int((~moved).sum()))
    check(torch.equal(table0[untouched], before["untouched"]),
          "an untouched row of table 0 moved")
    check(0.0 <= metrics["probs_auc"] <= 1.0
          and 0.0 <= metrics["logits_accuracy"] <= 1.0,
          "DLRM evaluation metrics out of range: %s" % metrics)
    out = {
        "model": "dlrm, %(num_tables)d tables x %(table_size)d rows x "
                 "%(embedding_dim)d, fp32, SGD 0.01" % DLRM,
        "minibatch": DLRM_BATCH, "steps": DLRM_STEPS,
        "losses": losses, "expected_first_loss": first,
        "first_loss_tol": first_tol,
        "step_ms": [s["ms"] for s in steps],
        "launches_per_step": steps[-1]["launches"],
        "launches_evaluation": eval_launches,
        "eval": metrics, "record_write_s": write_s, "wall_s": wall,
        "peak_memory_bytes_run": int(torch.cuda.max_memory_allocated()),
        "rows_checked": {"touched_moved": 64, "untouched_equal":
                         int(len(untouched))},
    }
    return out, executor, launches


def time_dlrm_steps(executor, rng, steps=10, prof_steps=3):
    """Where a bench-width DLRM step's time goes: a pre-built batch with
    ids uniform over the 1.2M rows (bench.py's run_dlrm_bench), one warm
    step, `steps` steps on the host clock, then `prof_steps` more under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    trainer, state = executor.trainer, executor.state
    batch = ({"dense": rng.rand(DLRM_BATCH, 13).astype(np.float32),
              "sparse": rng.randint(0, DLRM["table_size"], size=(
                  DLRM_BATCH, DLRM["num_tables"])).astype(np.int32)},
             rng.randint(2, size=(DLRM_BATCH,)).astype(np.int32))
    state, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.percentile(times, 50))
    peak = int(torch.cuda.max_memory_allocated())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(prof_steps):
            state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    summary = device_summary(events, prof_steps, step_ms, top=8)
    for name, kernel in (("embedding_gather", "gather_kernel"),
                         ("row_update", "row_update_kernel")):
        own = [e for e in events if kernel in e.key
               and e.device_type == torch.autograd.DeviceType.CUDA]
        total_us = sum(_device_us(e) for e in own)
        summary["%s_ms_per_step" % name] = total_us / 1e3 / prof_steps
        summary["%s_ms_per_launch" % name] = total_us / 1e3 / max(
            1, sum(e.count for e in own))
    return {
        "batch": "pre-built, ids uniform over %d rows" % DLRM["table_size"],
        "step_ms": times, "step_ms_p50": step_ms,
        "samples_per_s": DLRM_BATCH / (step_ms / 1e3),
        "peak_memory_bytes": peak,
        **summary,
        "host_ops_per_step": sum(e.count for e in events
                                 if e.key.startswith("aten::")) / prof_steps,
    }, batch


def numpy_dlrm_params(cfg, seed):
    """DLRM params in the flax layout, drawn by numpy: keras-uniform
    tables, fan-in-scaled normal kernels, small biases."""
    rs = np.random.RandomState(seed)
    d, n = cfg["embedding_dim"], cfg["num_tables"]
    params = {}

    def dense(name, sizes, width):
        for i, out in enumerate(sizes):
            params["%s_%d/kernel" % (name, i)] = (
                rs.standard_normal((width, out)) / np.sqrt(width)).astype(
                    np.float32)
            params["%s_%d/bias" % (name, i)] = (
                0.1 * rs.standard_normal(out)).astype(np.float32)
            width = out

    dense("bottom", (64, 32, d), 13)
    for t in range(n):
        params["table_%d/embedding_table" % t] = rs.uniform(
            -0.05, 0.05, (cfg["table_size"], d)).astype(np.float32)
    dense("top", (64, 1), d + n * (n + 1) // 2)
    return params


def compare_dlrm_step(rng):
    """One SGD step of a small DLRM (every table tapped) on the card and
    on the CPU (plain versions), same numpy weights and batch, fp32 with
    TF32 off: the loss, every table and MLP weight after the step."""
    cfg = dict(table_size=20000, num_tables=4, embedding_dim=32)
    sd = dlrm_params_from_flax(numpy_dlrm_params(cfg, seed=5))
    sparse = rng.randint(0, 64, size=(256, 26)).astype(np.int32)
    batch = ({"dense": (4 * rng.rand(256, 13)).astype(np.float32),
              "sparse": sparse}, rng.randint(2, size=(256,)).astype(np.int32))
    runs = {}
    for dev in ("cuda", "cpu"):
        trainer = Trainer(load_model_spec_from_module(dzoo),
                          model_params=_dlrm_params_str(cfg), device=dev)
        state = trainer.init_state(batch, params=sd)
        check(len(state.embed_opt_state) == cfg["num_tables"],
              "small DLRM: not every table is tapped")
        state, loss = trainer.train_step(state, batch)
        runs[dev] = (loss, {k: p.detach().cpu() for k, p in
                            state.params.items()})
    (gl, gp), (cl, cp) = runs["cuda"], runs["cpu"]
    loss_err = abs(gl - cl) / abs(cl)
    errs = {k: (gp[k] - cp[k]).abs().max().item() for k in cp}
    worst = max(errs, key=errs.get)
    # each tensor's change in the step, card against cpu, relative to the
    # largest change the cpu made in that tensor
    change = {k: float((cp[k] - sd[k]).abs().max()) for k in cp}
    check(all(change.values()), "DLRM step left a parameter unchanged: %s"
          % [k for k, c in change.items() if not c])
    delta_errs = {k: float(((gp[k] - sd[k]) - (cp[k] - sd[k])).abs().max())
                  / change[k] for k in cp}
    worst_delta = max(delta_errs, key=delta_errs.get)
    tables = [k for k in cp if k.startswith("table_")]
    moved = sum(int((gp[k] != sd[k]).any(dim=1).sum()) for k in tables)
    log("dlrm step cuda vs cpu: loss %.7f / %.7f (rel %.3g); worst param "
        "err %.3g (%s); worst change err %.3g of the change (%s); %d table "
        "rows moved, max |change| tables %.3g, MLPs %.3g"
        % (gl, cl, loss_err, errs[worst], worst, delta_errs[worst_delta],
           worst_delta, moved, max(change[k] for k in tables),
           max(c for k, c in change.items() if k not in tables)))
    check(loss_err <= DLRM_STEP_TOL, "DLRM step loss: card %.7f vs cpu %.7f"
          % (gl, cl))
    check(errs[worst] <= DLRM_STEP_TOL, "DLRM step %s: card and cpu differ "
          "by %.3g" % (worst, errs[worst]))
    check(delta_errs[worst_delta] <= DLRM_STEP_DELTA_TOL_REL,
          "DLRM step %s: the card's change differs from the cpu's by %.3g "
          "of it" % (worst_delta, delta_errs[worst_delta]))
    check(moved > 0, "DLRM step moved no table row")
    return {"loss_cuda": gl, "loss_cpu": cl, "loss_rel_err": loss_err,
            "param_max_abs_err": errs[worst], "worst_param": worst,
            "change_max_rel_err": delta_errs[worst_delta],
            "worst_change_param": worst_delta,
            "table_change_max_abs": max(change[k] for k in tables),
            "mlp_change_max_abs": max(c for k, c in change.items()
                                      if k not in tables),
            "table_rows_moved": moved, "limit": DLRM_STEP_TOL,
            "change_limit_rel": DLRM_STEP_DELTA_TOL_REL}


# ----------------------------------------------------------------- timings


def _timing_entry(name, source, replaces, shape, fn, plain, library,
                  work, launches, errors, plain_eager=False, peak=None,
                  cold=False):
    """`library`: a callable timed like the kernel, or (ms, what) timed
    by the caller, or None. `plain_eager`: time the plain version with
    plain calls between CUDA events (a plain version that syncs with the
    host cannot be captured in a CUDA graph). `peak`: the operations'
    peak rate (default bf16). `cold`: fn, plain and library are lists of
    calls over disjoint data, timed per call with L2 flushed before each
    round (timed_cold_ms); `work` is that of one call."""
    if cold:
        ms, eager_ms = timed_cold_ms(fn)
        plain_ms = timed_cold_ms(plain, graph=not plain_eager)[0]
        if library is not None:
            library = (timed_cold_ms(library)[0], None)
    else:
        ms, eager_ms = timed_ms(fn)
        if plain_eager:
            plain()
            plain_ms = _events_ms(plain, 20)
        else:
            plain_ms, _ = timed_ms(plain)
        if callable(library):
            library = (timed_ms(library)[0], None)
    bound, bound_by = bound_ms(*work, peak=peak or PEAK_BF16_FLOPS)
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "shape": shape, "launches": launches[name],
        "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None if library is None else library[0],
    }
    if cold:
        entry["timing"] = ("%d calls over disjoint tables and ids per "
                           "round, L2 flushed before each round" % len(fn))
    if library is not None and library[1]:
        entry["library_call"] = library[1]
    entry.update(errors)
    return entry


def flash_bwd_work(b, h, hkv, l, d, itemsize, dkv, causal=True):
    """(operations, bytes) of one backward pass at lq = lk = l, causal
    unless `causal` is False: 6*d operations per visible (query, key)
    pair for dq (S, dP, dQ), 8*d for dk/dv (S, dP, dV, dK); each input
    read once and each output written once: dq reads q, k, v, out, dO
    and the lse, writes dq and delta; dk/dv reads q, k, v, dO, lse and
    delta, writes dk and dv."""
    pairs = l * (l + 1) // 2 if causal else l * l
    rows_q, rows_kv = b * h * l, b * hkv * l
    if dkv:
        return (8 * d * pairs * b * h,
                itemsize * d * (2 * rows_q + 4 * rows_kv) + 8 * rows_q)
    return (6 * d * pairs * b * h,
            itemsize * d * (4 * rows_q + 2 * rows_kv) + 8 * rows_q)


def sdpa_backward_ms(q, k, v, do, causal=True):
    """(ms, what) of PyTorch's own flash-attention backward computing dq,
    dk and dv in one call at these inputs (causal unless `causal` is
    False), timed eagerly between CUDA events; used only as a yardstick,
    never by the port. Where the aten op does not take these inputs
    (its signature in this PyTorch, or fp32, which its flash kernel
    refuses), SDPA's autograd backward is timed instead (forward +
    backward less the forward; the memory-efficient kernel for fp32)."""
    aten = torch.ops.aten
    try:
        fwd = aten._scaled_dot_product_flash_attention(q, k, v, 0.0, causal,
                                                       False)
        out, lse, cq, ck, mq, mk, seed, offset = fwd[:8]

        def run():
            return aten._scaled_dot_product_flash_attention_backward(
                do, q, k, v, out, lse, cq, ck, mq, mk, 0.0, causal, seed,
                offset)

        run()
        torch.cuda.synchronize()
        return (_events_ms(run, 20),
                "aten._scaled_dot_product_flash_attention_backward: dq, dk "
                "and dv in one call")
    except (RuntimeError, TypeError) as e:
        log("aten flash backward not callable here (%s); timing SDPA's "
            "autograd backward instead" % e)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def fwd_only():
        return F.scaled_dot_product_attention(*leaves, is_causal=causal)

    def fwd_bwd():
        torch.autograd.grad(fwd_only(), leaves, do)

    fwd_bwd()
    torch.cuda.synchronize()
    return (_events_ms(fwd_bwd, 20) - _events_ms(fwd_only, 20),
            "F.scaled_dot_product_attention autograd backward (forward + "
            "backward less forward): dq, dk and dv")


def time_backward(gen, train_launches, bwd_err):
    """Kernels A, C and D at the training shape: b = 8, h = 8, l = 1024,
    d = 128, causal, bf16, C and D on the forward kernel's out and lse;
    first against the plain versions that round as they do (fwd_ok,
    rounded_ok). A beside SDPA, C and D beside aten's flash backward."""
    b, h, l, d = TRAIN_BATCH, 8, FLAGSHIP["seq_len"], 128
    q, k, v = flash_inputs(gen, b, h, h, l, d, torch.bfloat16)
    do = flash_inputs(gen, b, h, h, l, d, torch.bfloat16)[0]
    out, lse = att.flash_forward(q, k, v, causal=True)
    rounded = rounded_bwd_errs(q, k, v, out, lse, do, causal=True)
    log("flash bwd at the training shape against the rounded plain "
        "version (fp32 gradients): %s" % rounded)
    for name, e in rounded.items():
        check(rounded_ok(e),
              "%s disagrees with its rounded plain version at the training "
              "shape: %s" % (name, e))
    _dq, delta = att.flash_backward_dq(q, k, v, out, lse, do, causal=True)
    library = sdpa_backward_ms(q, k, v, do)
    shape = "b=%d h=%d lq=lk=%d d=%d causal bf16" % (b, h, l, d)
    fwd_err = flash_fwd_errs(q, k, v, out, lse, True, {})
    log("flash fwd at the training shape: %s" % fwd_err)
    check(fwd_ok(fwd_err), "flash_fwd disagrees with its rounded plain "
          "version at the training shape: %s" % fwd_err)
    fwd = _timing_entry(
        "flash_fwd", "elasticdl_tpu_torch/csrc/flash_fwd.cu",
        "elasticdl_tpu/ops/attention.py:941", shape,
        lambda: att.flash_forward(q, k, v, causal=True),
        lambda: att.flash_attention_plain(q, k, v, causal=True,
                                          bf16_operands=True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        flash_work(b, h, h, l, l, d, 2), train_launches,
        dict(fwd_err, max_err=fwd_err["max_abs_err"]))
    fwd["launches_per_step"] = train_launches["flash_fwd"] // TRAIN_STEPS
    entries = [fwd]
    for name, line, fn, plain, dkv in (
            ("flash_bwd_dq", 1241,
             lambda: att.flash_backward_dq(q, k, v, out, lse, do, causal=True),
             lambda: att.flash_backward_dq_plain(q, k, v, out, lse, do,
                                                 causal=True), False),
            ("flash_bwd_dkv", 1294,
             lambda: att.flash_backward_dkv(q, k, v, do, lse, delta,
                                            causal=True),
             lambda: att.flash_backward_dkv_plain(q, k, v, do, lse, delta,
                                                  causal=True), True)):
        entry = _timing_entry(
            name, "elasticdl_tpu_torch/csrc/flash_bwd.cu",
            "elasticdl_tpu/ops/attention.py:%d" % line, shape, fn, plain,
            library, flash_bwd_work(b, h, h, l, d, 2, dkv), train_launches,
            dict(bwd_err[name], max_err=bwd_err[name]["max_abs_err"]))
        entry["launches_per_step"] = train_launches[name] // TRAIN_STEPS
        entry["path_shape_rounded_rms_rel_err"] = rounded[name]["rms_rel_err"]
        entry["path_shape_rounded_max_rel_err"] = rounded[name]["max_rel_err"]
        entry["path_shape_unrounded_rms_rel_err"] = rounded[name][
            "unrounded_rms_rel_err"]
        entries.append(entry)
    return entries


PAGED_COLD_LAYERS = 8  # a decode step's paged calls: one per layer


def paged_cold(entry, args, window=None, t=1, int8=False):
    """Adds kernel B's cold time to its timing entry: PAGED_COLD_LAYERS
    calls over disjoint arena pairs, as a decode step issues one per
    layer (args' own pools, then pools drawn on the card from a generator
    of their own; int8 arenas quantized from them), L2 flushed before
    each round (timed_cold_ms). On the serving path each layer's arena
    was last read a decode step earlier, with the other layers' arenas
    and weights read in between, so its rows come from device memory;
    the hot time (`ms`, one call replayed) finds them in L2."""
    gen = torch.Generator(device="cuda").manual_seed(PAGED_TIMING_SEED + 100)
    pools = [tuple(args[1:3])] + [
        tuple(torch.randn(args[1].shape, generator=gen, device="cuda").to(
            args[1].dtype) for _ in range(2))
        for _ in range(PAGED_COLD_LAYERS - 1)]
    calls = []
    for k_pool, v_pool in pools:
        call_args = (args[0], k_pool, v_pool, args[3], args[4])
        if int8:
            call_args = quantize_pools(call_args)
        calls.append(lambda a=call_args: att.paged_decode_partials(
            *a, window=window, t=t))
    entry["cold_ms"] = timed_cold_ms(calls)[0]
    entry["cold_timing"] = (
        "%d calls over disjoint arena pairs per round (a decode step's "
        "layers), L2 flushed before each round" % PAGED_COLD_LAYERS)
    return entry


def time_kernels(gen, launches, flash_err, paged_err):
    """Each serving kernel at the main path's shapes: the largest prefill
    bucket (lq = 512) for A; for B the 8-slot decode step (t = 1, ragged
    lengths under 1000, split kernel) and a 128-token suffix tile over
    the 256-token shared prefix (tile kernel), drawn from a generator of
    their own so that every run, and the int8 timings, see the same
    lengths. Returns the entries and B's (name, t, label, inputs)."""
    q, k, v = flash_inputs(gen, 1, 8, 8, 512, 128, torch.bfloat16)
    flash = _timing_entry(
        "flash_fwd", "elasticdl_tpu_torch/csrc/flash_fwd.cu",
        "elasticdl_tpu/ops/attention.py:941",
        "b=1 h=8 lq=lk=512 d=128 causal bf16",
        lambda: att.flash_forward(q, k, v, causal=True),
        lambda: att.flash_attention_plain(q, k, v, causal=True,
                                          bf16_operands=True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        flash_work(1, 8, 8, 512, 512, 128, 2), launches,
        dict(flash_err, max_err=flash_err["max_abs_err"]),
    )
    paged_errors = {"max_abs_err": paged_err[0], "max_err": paged_err[0],
                    "max_rel_err": paged_err[1]}
    entries, cases = [flash], []
    paged_gen = torch.Generator().manual_seed(PAGED_TIMING_SEED)
    for name, t, lengths, label in (
            ("paged_decode", 1, None, "b=8 t=1"),
            ("paged_decode_tile", 128, [256], "b=1 t=128")):
        args, lens = paged_inputs(paged_gen, b=1 if lengths else 8, t=t,
                                  lengths=lengths)
        cases.append((name, t, label, args, lens))
        entries.append(paged_cold(_timing_entry(
            name, "elasticdl_tpu_torch/csrc/paged_decode.cu",
            "elasticdl_tpu/ops/attention.py:591",
            "%s hkv=8 d=128 bs=16 m=64 bf16, live rows %d"
            % (label, sum(lens)),
            lambda args=args: att.paged_decode_partials(*args),
            lambda args=args: att.paged_decode_partials_plain(*args),
            None, paged_work(lens, 8, t, 128, 2, 64), launches,
            paged_errors, peak=PEAK_FP32_FLOPS), args, t=t))
    return entries, cases


# fp32 operations per element of each row rule (a multiply, an add, a
# square root or a divide counts one)
ROW_FLOPS = {"sgd": 2, "momentum": 6, "adam": 13, "adagrad": 7}


def check_embedding_kernels_at_path_shape(tables, ids, uniq, summed):
    """Kernels E and F against their plain versions at the path's size:
    table 0 (1,200,000 x 32 fp32) with the 4096 ids of the uniform
    batch's column 0, and for F each rule over those ids deduplicated,
    on clones of the table and of fresh slot tables. E must be equal;
    F within ROW_TOL_REL per table, rows and slot rows the ids do not
    name bit-identical. Returns (E's max |err|, {rule: (max |err|, max
    relative err)})."""
    vocab = tables.shape[1]
    out = eo.embedding_gather(tables[0], ids[0])
    ref = eo.embedding_gather_plain(tables[0], ids[0])
    gather_err = (out - ref).abs().max().item()
    check(torch.equal(out, ref), "gather kernel differs from its plain "
          "version at the path's shape: max |err| %.3g" % gather_err)
    cuda_gen = torch.Generator(device="cuda").manual_seed(2)
    untouched = torch.ones(vocab, dtype=torch.bool, device="cuda")
    untouched[uniq[0][uniq[0] >= 0].long()] = False
    row_errs = {}
    for rule, (kwargs, hyper) in ROW_RULES.items():
        mine = [tables[0].clone()] + [
            torch.rand(vocab, tables.shape[2], device="cuda",
                       generator=cuda_gen) * 0.1
            for _ in range(ROW_TABLES[rule] - 1)]
        before = [t.clone() for t in mine]
        plain = [t.clone() for t in mine]
        ROW_WRAPPERS[rule](*mine, uniq[0], summed[0], **kwargs)
        eo.row_update_plain(rule, plain, uniq[0], summed[0], hyper)
        rels, worst = [], 0.0
        for t, p, b in zip(mine, plain, before):
            check(torch.equal(t[untouched], b[untouched]),
                  "row_update %s moved a row it was not given at the "
                  "path's shape" % rule)
            rels.append(rel_err(t, p))
            worst = max(worst, (t - p).abs().max().item())
        check(max(rels) <= ROW_TOL_REL, "row_update %s disagrees with its "
              "plain version at the path's shape: %s" % (rule, rels))
        row_errs[rule] = (worst, max(rels))
        del mine, before, plain
    log("gather and row_update at the path's shape (%d x %d fp32, %d ids, "
        "%d unique): gather equal; row_update %s" % (
            vocab, tables.shape[2], ids[0].numel(),
            int((uniq[0] >= 0).sum()),
            {r: "%.3g" % e[1] for r, e in row_errs.items()}))
    return gather_err, row_errs


def check_grouped_at_path_shape(tables, ids, uniq, summed):
    """The grouped E and F against the per-table plain versions at the
    path's size: the 26 tables (1,200,000 x 32 fp32) with the uniform
    batch's 26 id columns in one [26, 4096] matrix, and for F each rule
    over each column deduplicated, each table with its own learning rate
    and count (grouped_hyper), on clones of the tables and of fresh slot
    tables. E must be equal; F within ROW_TOL_REL per table, and rows
    the ids do not name equal to the plain version's (which leaves them
    as they were). Returns (E's max |err|, {rule: (max |err|, max
    relative err)})."""
    n_tab, vocab, d = tables.shape
    out = eo.embedding_gather_many(list(tables), torch.stack(ids))
    gather_err = 0.0
    for t in range(n_tab):
        ref = eo.embedding_gather_plain(tables[t], ids[t])
        gather_err = max(gather_err, (out[t] - ref).abs().max().item())
        check(torch.equal(out[t], ref), "grouped gather differs from the "
              "plain version of table %d at the path's shape: max |err| "
              "%.3g" % (t, gather_err))
    del out
    cuda_gen = torch.Generator(device="cuda").manual_seed(3)
    untouched = []
    for u in uniq:
        mask = torch.ones(vocab, dtype=torch.bool, device="cuda")
        mask[u[u >= 0].long()] = False
        untouched.append(mask)
    hypers = {rule: [grouped_hyper(rule, t, n_tab) for t in range(n_tab)]
              for rule in ROW_RULES}
    row_errs = {}
    for rule in ROW_RULES:
        mine = [[tables[t].clone()] + [
            torch.rand(vocab, d, device="cuda", generator=cuda_gen) * 0.1
            for _ in range(ROW_TABLES[rule] - 1)] for t in range(n_tab)]
        plain = [[x.clone() for x in g] for g in mine]
        eo.row_update_many(rule, mine, list(uniq), list(summed),
                           hypers[rule])
        eo.row_update_many_plain(rule, plain, uniq, summed, hypers[rule])
        rels, worst = [], 0.0
        for group, ref, mask in zip(mine, plain, untouched):
            for x, y in zip(group, ref):
                check(torch.equal(x[mask], y[mask]), "grouped row_update "
                      "%s moved a row it was not given at the path's shape"
                      % rule)
                rels.append(rel_err(x, y))
                worst = max(worst, (x - y).abs().max().item())
        check(max(rels) <= ROW_TOL_REL, "grouped row_update %s disagrees "
              "with the plain versions at the path's shape: %.3g"
              % (rule, max(rels)))
        row_errs[rule] = (worst, max(rels))
        del mine, plain
        torch.cuda.empty_cache()
    log("grouped gather and row_update at the path's shape (%d tables of "
        "%d x %d fp32, %d ids each): gather equal; row_update %s" % (
            n_tab, vocab, d, ids[0].numel(),
            {r: "%.3g" % e[1] for r, e in row_errs.items()}))
    return gather_err, row_errs


def time_embedding_kernels(launches, gather_err, row_err, batch, sweep):
    """Kernels E and F at the DLRM path's shapes, first held against
    their plain versions there (check_embedding_kernels_at_path_shape,
    check_grouped_at_path_shape). 26 tables of 1,200,000 x 32 fp32, and
    for table t the 4096 ids of the uniform batch's column t: E gathers
    them; F applies each rule over them deduplicated (about 4,090
    unique, the rest padding) with their summed gradient rows. Each
    kernel twice: one table a call (`embedding_gather`, `row_update`:
    the 26 calls of a step in one CUDA graph, per call) and grouped
    (`embedding_gather_many`, `row_update_many`: the step's one call
    over the 26 tables, per step), with L2 flushed before each replay
    (timed_cold_ms). F's entries are the SGD rule, the path's; the other
    rules ride along under `other_rules`. Bound per table: bytes 2 n d 4
    + 4 n for E, n_u d 4 (2 tables + 1) + 4 n for F, at 3.35 TB/s;
    operations at the fp32 peak; a step's bound is the sum of its
    tables'. `sweep`: check_grouped_sweep's result."""
    vocab, d, n = DLRM["table_size"], DLRM["embedding_dim"], DLRM_BATCH
    n_tab = DLRM["num_tables"]
    cuda_gen = torch.Generator(device="cuda").manual_seed(1)
    tables = torch.randn(n_tab, vocab, d, device="cuda", generator=cuda_gen)
    table_list = list(tables)
    ids = [torch.as_tensor(np.ascontiguousarray(batch[0]["sparse"][:, t]),
                           device="cuda") for t in range(n_tab)]
    ids_matrix = torch.stack(ids)
    ids_long = [i.long() for i in ids]
    grads = torch.randn(n_tab, n, d, device="cuda", generator=cuda_gen)
    uniq, summed = zip(*(eo.dedup_indexed_slices(i, g)
                         for i, g in zip(ids, grads)))
    uniq, summed = list(uniq), list(summed)
    n_u = [int((u >= 0).sum()) for u in uniq]
    valid = [u[:k].long() for u, k in zip(uniq, n_u)]
    valid_sum = [s[:k] for s, k in zip(summed, n_u)]
    path_gather_err, path_row_err = check_embedding_kernels_at_path_shape(
        tables, ids, uniq, summed)
    many_gather_err, many_row_err = check_grouped_at_path_shape(
        tables, ids, uniq, summed)
    gather_work = (0, 2 * n * d * 4 + 4 * n)
    gather_errors = {
        "max_abs_err": max(gather_err, path_gather_err, many_gather_err,
                           sweep[0]),
        "max_err": max(gather_err, path_gather_err, many_gather_err,
                       sweep[0]),
        "path_shape_max_abs_err": path_gather_err,
        "grouped_path_shape_max_abs_err": many_gather_err,
        "grouped_sweep_max_abs_err": sweep[0],
        "grouped_sweep_cases": sweep[2]}
    gather = _timing_entry(
        "embedding_gather", "elasticdl_tpu_torch/csrc/embedding_gather.cu",
        "elasticdl_tpu/ops/embedding_ops.py:72",
        "%d ids into a %d x %d fp32 table" % (n, vocab, d),
        [lambda t=t: eo.embedding_gather(tables[t], ids[t])
         for t in range(n_tab)],
        [lambda t=t: eo.embedding_gather_plain(tables[t], ids[t])
         for t in range(n_tab)],
        [lambda t=t: torch.index_select(tables[t], 0, ids_long[t])
         for t in range(n_tab)],
        gather_work, launches, gather_errors,
        peak=PEAK_FP32_FLOPS, cold=True)
    gather["library_call"] = "torch.index_select(table, 0, ids)"
    gather_many = _timing_entry(
        "embedding_gather_many",
        "elasticdl_tpu_torch/csrc/embedding_gather.cu",
        "elasticdl_tpu/ops/embedding_ops.py:72",
        "%d tables x %d ids into %d x %d fp32 tables, one call"
        % (n_tab, n, vocab, d),
        [lambda: eo.embedding_gather_many(table_list, ids_matrix)],
        [lambda: eo.embedding_gather_many_plain(table_list, ids_matrix)],
        [lambda: [torch.index_select(tables[t], 0, ids_long[t])
                  for t in range(n_tab)]],
        (0, n_tab * gather_work[1]), launches, gather_errors,
        peak=PEAK_FP32_FLOPS, cold=True)
    gather_many["library_call"] = ("%d x torch.index_select(table, 0, ids) "
                                   "in one CUDA graph" % n_tab)
    entries, many = {}, {}
    for rule, (kwargs, hyper) in ROW_RULES.items():
        n_t = ROW_TABLES[rule]
        slots = [torch.rand(n_tab, vocab, d, device="cuda",
                            generator=cuda_gen) * 0.1 for _ in range(n_t - 1)]
        group = [[tables[t]] + [s[t] for s in slots] for t in range(n_tab)]
        library = library_many = None
        if rule == "sgd":
            lr = kwargs["lr"]
            library = [lambda t=t: tables[t].index_add_(
                0, valid[t], valid_sum[t], alpha=-lr) for t in range(n_tab)]
            library_many = [lambda: [call() for call in library]]
        path_abs, path_rel = path_row_err[rule]
        many_abs, many_rel = many_row_err[rule]
        errors = {"max_abs_err": max(row_err[0], path_abs, many_abs),
                  "max_err": max(row_err[0], path_abs, many_abs),
                  "max_rel_err": max(row_err[1], path_rel, many_rel,
                                     sweep[1]),
                  "path_shape_max_abs_err": path_abs,
                  "path_shape_max_rel_err": path_rel,
                  "grouped_path_shape_max_rel_err": many_rel,
                  "grouped_sweep_max_rel_err": sweep[1]}
        mean_u = sum(n_u) / n_tab
        work = (ROW_FLOPS[rule] * mean_u * d,
                mean_u * d * 4 * (2 * n_t + 1) + 4 * n)
        entries[rule] = _timing_entry(
            "row_update", "elasticdl_tpu_torch/csrc/row_update.cu",
            "elasticdl_tpu/ops/embedding_ops.py:216",
            "%s rule, %d ids (%.1f unique on average) into %d x %d fp32 "
            "tables" % (rule, n, mean_u, vocab, d),
            [lambda t=t: ROW_WRAPPERS[rule](*group[t], uniq[t], summed[t],
                                            **kwargs)
             for t in range(n_tab)],
            [lambda t=t: eo.row_update_plain(rule, group[t], uniq[t],
                                             summed[t], hyper)
             for t in range(n_tab)],
            library, work, launches, errors,
            plain_eager=True, peak=PEAK_FP32_FLOPS, cold=True)
        hypers = [hyper] * n_tab
        many[rule] = _timing_entry(
            "row_update_many", "elasticdl_tpu_torch/csrc/row_update.cu",
            "elasticdl_tpu/ops/embedding_ops.py:216",
            "%s rule, %d tables x %d ids (%.1f unique on average) into "
            "%d x %d fp32 tables, one call" % (rule, n_tab, n, mean_u, vocab,
                                              d),
            [lambda: eo.row_update_many(rule, group, uniq, summed, hypers)],
            [lambda: eo.row_update_many_plain(rule, group, uniq, summed,
                                              hypers)],
            library_many,
            (ROW_FLOPS[rule] * sum(n_u) * d,
             sum(n_u) * d * 4 * (2 * n_t + 1) + 4 * n * n_tab),
            launches, errors, plain_eager=True, peak=PEAK_FP32_FLOPS,
            cold=True)
        del slots, group
        torch.cuda.empty_cache()
    out = []
    for entry, step_of in ((gather, n_tab), (gather_many, 1)):
        entry["ms_per_step"] = entry["ms"] * step_of
        entry["bound_ms_per_step"] = entry["bound_ms"] * step_of
        entry["library_ms_per_step"] = entry["library_ms"] * step_of
        out.append(entry)
    for name, by_rule, step_of in (("row_update", entries, n_tab),
                                   ("row_update_many", many, 1)):
        row = by_rule.pop("sgd")
        for entry in [row] + list(by_rule.values()):
            entry["ms_per_step"] = entry["ms"] * step_of
            entry["plain_ms_per_step"] = entry["plain_ms"] * step_of
            entry["bound_ms_per_step"] = entry["bound_ms"] * step_of
            if entry["library_ms"] is not None:
                entry["library_ms_per_step"] = entry["library_ms"] * step_of
        row["plain_timing"] = "eager (its boolean mask syncs with the host)"
        row["other_rules"] = {
            rule: {k: e[k] for k in (
                "shape", "ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "ms_per_step", "bound_ms_per_step",
                "plain_ms_per_step", "path_shape_max_rel_err",
                "grouped_path_shape_max_rel_err") if k in e}
            for rule, e in by_rule.items()}
        out.append(row)
    out[2]["library_call"] = ("Tensor.index_add_(0, unique ids, summed rows, "
                              "alpha=-lr) over the valid ids")
    out[3]["library_call"] = ("%d x Tensor.index_add_(0, unique ids, summed "
                              "rows, alpha=-lr) in one CUDA graph" % n_tab)
    for entry in out[1::2]:
        entry["timing"] = ("one call over the %d tables of a step per round, "
                           "L2 flushed before each round: ms, plain_ms, "
                           "bound_ms and library_ms are a step's" % n_tab)
        entry["ms_per_table"] = entry["ms"] / n_tab
    return [out[0], out[2], out[1], out[3]]


def time_paged_int8(cases, launches, errors):
    """The int8 split and tile kernels at the int8 serving path's shapes,
    on the float timings' inputs (time_kernels' `cases`) quantized: the
    8-slot decode step and a 128-row suffix tile over a 256-token prefix,
    hkv = 8, d = 128, block 16, int8 arenas with their fp32 scale
    pools."""
    entries = []
    for name, t, label, args, lens in cases:
        int8_args = quantize_pools(args)
        entries.append(paged_cold(_timing_entry(
            name + "_int8", "elasticdl_tpu_torch/csrc/paged_decode.cu",
            "elasticdl_tpu/ops/attention.py:591 (int8 branch :613-634)",
            "%s hkv=8 d=128 bs=16 m=64 int8 + fp32 row scales, live rows "
            "%d" % (label, sum(lens)),
            lambda a=int8_args: att.paged_decode_partials(*a),
            lambda a=int8_args: att.paged_decode_partials_plain(*a),
            None, paged_work(lens, 8, t, 128, 1, 64, int8=True), launches,
            errors, peak=PEAK_FP32_FLOPS), args, t=t, int8=True))
    return entries


# kernel G's rules: the TPU kernel each replaces (optimizer_kernels.py
# line) and its fp32 operations per element, as ROW_FLOPS counts them
DENSE_LINES = {"sgd": 77, "momentum": 94, "adam": 123, "adam_amsgrad": 130,
               "adagrad": 172}
DENSE_FLOPS = dict(ROW_FLOPS, adam_amsgrad=ROW_FLOPS["adam"] + 1)


def run_dense_path():
    """Path B, the dense update API, at scripts/bench_optimizer_kernels.py's
    size (DENSE_N fp32 elements): each rule takes DENSE_STEPS steps through
    its public wrapper, carrying its parameter and slots from step to step
    (Adam's step count advancing), as a caller drives it. Every result
    must be finite and each rule's kernel must launch once per step.
    Returns (metrics, launch counts)."""
    cuda_gen = torch.Generator(device="cuda").manual_seed(3)
    out = {"n": DENSE_N, "dtype": "float32", "steps": DENSE_STEPS}
    torch.cuda.synchronize()
    ok.reset_launch_counts()
    t0 = time.perf_counter()
    for rule, kw in DENSE_CASES[:len(DENSE_RULES)]:
        param, slots, grad = dense_inputs(cuda_gen, rule, (DENSE_N,),
                                          torch.float32)
        for step in range(1, DENSE_STEPS + 1):
            kw_step = dict(kw, step=step) if "step" in kw else kw
            param, *slots = dense_call(rule, kw_step, param, slots, grad)
        check(all(bool(torch.isfinite(t).all()) for t in (param, *slots)),
              "dense %s: non-finite result" % rule)
        del param, slots, grad
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    launches = dict(ok.KERNEL_LAUNCHES)
    for rule in DENSE_RULES:
        check(launches["dense_" + rule] == DENSE_STEPS,
              "dense %s launched its kernel %d times in %d steps"
              % (rule, launches["dense_" + rule], DENSE_STEPS))
    out["launches"] = launches
    return out, launches


def _torch_optimizer_ms(rule, kw, param, slots, grad):
    """(ms, what) of one step of the torch.optim optimizer that makes the
    same update (momentum, Adam, AMSGrad, Adagrad), on a copy of the
    parameter with `grad` as its gradient, timed between CUDA events;
    used only as a yardstick, never by the port."""
    p = torch.nn.Parameter(param.clone())
    p.grad = grad
    if rule == "momentum":
        opt = torch.optim.SGD([p], lr=kw["lr"], momentum=kw["momentum"],
                              nesterov=kw["nesterov"])
        what = "torch.optim.SGD(momentum=0.9, nesterov=True).step()"
    elif rule == "adagrad":
        opt = torch.optim.Adagrad([p], lr=kw["lr"], foreach=True)
        what = "torch.optim.Adagrad(foreach=True).step()"
    else:
        amsgrad = rule == "adam_amsgrad"
        opt = torch.optim.Adam([p], lr=kw["lr"], amsgrad=amsgrad,
                               fused=True)
        what = "torch.optim.Adam(%sfused=True).step()" % (
            "amsgrad=True, " if amsgrad else "")
    opt.step()
    torch.cuda.synchronize()
    ms = _events_ms(opt.step, 10)
    del opt, p
    return ms, what


def time_dense(path_launches):
    """Kernel G at the path's size, each rule on fresh inputs: first held
    against its plain version there (max |err| / max |ref| per output
    within DENSE_TOL_REL), then timed (CUDA-graph replay), beside the
    plain version and the one PyTorch call that makes the same update
    (p.add(g, alpha=-lr) for SGD, a torch.optim step for the others).
    Bound: bytes, each tensor read or written once (2 x slots + 3
    tensors of 4 bytes per element), at 3.35 TB/s."""
    cuda_gen = torch.Generator(device="cuda").manual_seed(4)
    entries = []
    for rule, kw in DENSE_CASES[:len(DENSE_RULES)]:
        param, slots, grad = dense_inputs(cuda_gen, rule, (DENSE_N,),
                                          torch.float32)
        got = dense_call(rule, kw, param, slots, grad)
        ref = dense_plain(rule, kw, param, slots, grad)
        rel = max(rel_err(a, b) for a, b in zip(got, ref))
        e_abs = max((a - b).abs().max().item() for a, b in zip(got, ref))
        log("dense %s at %d fp32: rel err %.3g, max |err| %.3g"
            % (rule, DENSE_N, rel, e_abs))
        check(rel <= DENSE_TOL_REL, "dense %s disagrees with its plain "
              "version at the path's size: %.3g" % (rule, rel))
        del got, ref
        if rule == "sgd":
            library = (lambda: param.add(grad, alpha=-kw["lr"]),
                       "Tensor.add(grad, alpha=-lr)")
        else:
            library = _torch_optimizer_ms(rule, kw, param, slots, grad)
        n_arrays = 2 * DENSE_RULES[rule][0] + 3
        entry = _timing_entry(
            "dense_" + rule, "elasticdl_tpu_torch/csrc/optimizer_update.cu",
            "elasticdl_tpu/ops/optimizer_kernels.py:%d (pallas_call :57)"
            % DENSE_LINES[rule],
            "%d fp32 elements, %d tensors" % (DENSE_N, n_arrays),
            lambda: dense_call(rule, kw, param, slots, grad),
            lambda: dense_plain(rule, kw, param, slots, grad),
            library[0] if rule == "sgd" else library,
            (DENSE_FLOPS[rule] * DENSE_N, 4 * DENSE_N * n_arrays),
            path_launches, {"max_abs_err": e_abs, "max_err": e_abs,
                            "max_rel_err": rel},
            peak=PEAK_FP32_FLOPS)
        entry["library_call"] = library[1]
        entries.append(entry)
        del param, slots, grad
        torch.cuda.empty_cache()
    return entries


# ------------------------------------------- packed and windowed slices


WINDOW = 256  # the windowed flagship's attn_window
PACKED_BATCH, PACKED_STEPS = 8, 4  # the packed family's LocalExecutor run
PACKED_DOCS = 400  # records of 4-48 tokens, as gen_docs_like writes them
PACKED_WARM, PACKED_TIMED = 2, 4  # the packed flagship steps per layout
# a packed row's logits against each of its documents run alone, fp32 at
# flagship width with TF32 off: the runs differ only in the order of sums
# (a document's key tiles start at another offset in the row, cuBLAS may
# split a taller matrix otherwise), about 1e-6 of the largest logit
PACKED_LOGIT_TOL_REL = 1e-4
# a small windowed fp32 model served on the card and on the CPU: greedy
# streams must be equal; windows far shorter than the prompts
SMALL_WINDOWED = dict(vocab_size=4096, seq_len=256, embed_dim=256,
                      num_heads=2, num_layers=2, attn_window=32)
MASKED_FLASH_SMALL = [(4, 4, 64), (8, 4, 128), (8, 2, 64), (4, 1, 128)]


def masked_training_kernels(variant):
    return tuple("%s_%s" % (n, variant) for n in TRAINING_KERNELS)


def packed_segments(gen, b, l, docs=6):
    """[b, l] int32 ids of contiguous runs of ragged lengths, a one-token
    run first, drawn by `gen`."""
    seg = torch.zeros(b, l, dtype=torch.int32)
    for i in range(b):
        cuts = (torch.randperm(l - 2, generator=gen)[:docs - 2] + 2).tolist()
        for c in [1] + sorted(cuts):
            seg[i, c:] += 1
    return seg


def doc_rows(rng, n_rows, row_len, lo, hi, most_docs=False):
    """n_rows rows of the port's pack_sequences over documents of lo..hi
    tokens: (tokens, segment_ids, labels). The first rows (first-fit
    decreasing opens them with the longest documents), or with
    `most_docs` the rows holding the most documents."""
    vocab = FLAGSHIP["vocab_size"]
    docs = [rng.randint(0, vocab, size=rng.randint(lo, hi + 1))
            for _ in range(3 * n_rows * row_len // ((lo + hi) // 2) + 1)]
    tokens, seg, labels = packing.pack_sequences(docs, row_len)
    check(tokens.shape[0] >= n_rows, "too few packed rows")
    rows = np.arange(n_rows)
    if most_docs:
        rows = np.argsort(-docs_per_row(seg, labels), kind="stable")[:n_rows]
    return tokens[rows], seg[rows], labels[rows]


def docs_per_row(seg, labels):
    """Documents in each packed row: its segments that carry a target
    (the pad tail carries none)."""
    return np.array([
        sum(1 for sid in np.unique(s) if (l[s == sid] >= 0).any())
        for s, l in zip(np.asarray(seg), np.asarray(labels))])


def real_tokens(seg, labels):
    """Tokens of packed rows that belong to a document (packing_efficiency's
    count): a segment with m >= 2 tokens carries m - 1 targets; the pad
    tail carries none."""
    seg, labels = np.asarray(seg), np.asarray(labels)
    real = 0
    for r in range(seg.shape[0]):
        for sid in np.unique(seg[r]):
            n = int((labels[r][seg[r] == sid] != packing.IGNORE_LABEL).sum())
            real += n + 1 if n else 0
    return real


def _flash_case(q, k, v, do, causal, masks, grad_dtype=None, lse_bwd=None):
    """Kernels A, C, D on one input against their plain versions: (errors
    by kernel, the variant's name). `masks` may hold window, q_seg /
    k_seg and pos_offset; `grad_dtype` is the backward's output dtype
    (None: the input's); `lse_bwd` replaces the forward's lse in the
    backward (a ring's global lse). bf16 inputs: C and D also against
    the plain version that rounds P and dS as they do
    (rounded_bwd_errs)."""
    variant = att._variant("", masks.get("window"),
                           masks.get("q_seg") is not None,
                           bool(masks.get("pos_offset")))
    out, lse = att.flash_forward(q, k, v, causal=causal, **masks)
    lse_b = lse if lse_bwd is None else lse_bwd
    bwd = dict(masks, causal=causal, grad_dtype=grad_dtype)
    dq, delta = att.flash_backward_dq(q, k, v, out, lse_b, do, **bwd)
    dk, dv = att.flash_backward_dkv(q, k, v, do, lse_b, delta, **bwd)
    torch.cuda.synchronize()
    want = grad_dtype or q.dtype
    check(dq.dtype == dk.dtype == dv.dtype == want,
          "flash backward%s wrote %s, not %s" % (variant, dq.dtype, want))
    pdq, pdelta = att.flash_backward_dq_plain(q, k, v, out, lse_b, do, **bwd)
    pdk, pdv = att.flash_backward_dkv_plain(q, k, v, do, lse_b, pdelta,
                                            **bwd)
    errs = {"flash_fwd": flash_fwd_errs(q, k, v, out, lse, causal, masks)}
    rounded = {}
    if q.dtype == torch.bfloat16:
        rounded = rounded_bwd_errs(q, k, v, out, lse_b, do, causal=causal,
                                   **masks)
    for name, pairs in (("flash_bwd_dq", ((dq, pdq), (delta, pdelta))),
                        ("flash_bwd_dkv", ((dk, pdk), (dv, pdv)))):
        check(all(torch.isfinite(a.float()).all().item() for a, _ in pairs),
              "%s%s: non-finite output" % (name, variant))
        errs[name] = {
            "max_abs_err": max((a.float() - b.float()).abs().max().item()
                               for a, b in pairs),
            "max_rel_err": max(masked_rel_err(a.float(), b.float())
                               for a, b in pairs)}
        if rounded:
            errs[name]["rounded_rms_rel_err"] = rounded[name]["rms_rel_err"]
            errs[name]["rounded_max_rel_err"] = rounded[name]["max_rel_err"]
            errs[name]["unrounded_rms_rel_err"] = rounded[name][
                "unrounded_rms_rel_err"]
    check(torch.isfinite(out.float()).all().item(),
          "flash_fwd%s: non-finite output" % variant)
    return errs, variant


def _check_flash_errs(errs, variant, dtype, where):
    check(fwd_ok(errs["flash_fwd"]),
          "flash_fwd%s disagrees with its plain version at %s: %s"
          % (variant, where, errs["flash_fwd"]))
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        check(errs[name]["max_rel_err"] <= BWD_TOL_REL[dtype],
              "%s%s disagrees with its plain version at %s: %s"
              % (name, variant, where, errs[name]))
        check("rounded_rms_rel_err" not in errs[name] or rounded_ok({
            "rms_rel_err": errs[name]["rounded_rms_rel_err"],
            "unrounded_rms_rel_err": errs[name]["unrounded_rms_rel_err"]}),
              "%s%s disagrees with its rounded plain version at %s: %s"
              % (name, variant, where, errs[name]))


def _worst(acc, name, errs):
    slot = acc.setdefault(name, {})
    for key, value in errs.items():
        slot[key] = max(slot.get(key, 0.0), value)


def check_masked_flash(gen, rng):
    """Kernels A, C and D with their window and segment variants against
    their plain versions. Small shapes: fp32 and bf16, causal or not,
    windows none, 1, 2, 37 (no multiple of the 64-row tile) and 300
    (past the sequence), ragged packed segments or none, GQA groups 1, 2
    and 4, d 64 and 128, b = 2, l = 200 (ragged against the tiles). Then
    the training path's shape, b = 8, h = 8, l = 1024, d = 128, bf16,
    causal: window 256, and the segments of pack_sequences over
    documents of 64-1024 tokens. Limits: fwd_ok for A (FWD_F32_TOL_REL
    for fp32, FLASH_TOL_OUT / FLASH_TOL_LSE and the rounded limits for
    bf16), BWD_TOL_REL for C and D (by masked_rel_err), those of the
    unmasked kernels.
    Returns ({kernel variant: worst errors}, the path shape's worst
    errors, the path shape's inputs)."""
    worst, path_worst = {}, {}
    i = 0
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for window in (None, 1, 2, 37, 300):
                for packed in (False, True):
                    # i + i // 2: packed and unpacked cases each run all
                    # four shapes (i % 4 gives packed ones only d 128)
                    h, hkv, d = MASKED_FLASH_SMALL[(i + i // 2) % 4]
                    i += 1
                    q, k, v = flash_inputs(gen, 2, h, hkv, 200, d, dtype)
                    do = flash_inputs(gen, 2, h, h, 200, d, dtype)[0]
                    masks = {"window": window}
                    if packed:
                        seg = packed_segments(gen, 2, 200).cuda()
                        masks.update(q_seg=seg, k_seg=seg)
                    if window is None and not packed:
                        continue  # the unmasked kernels: check_flash_bwd
                    errs, variant = _flash_case(q, k, v, do, causal, masks)
                    where = ("h=%d hkv=%d d=%d causal=%s window=%s %s"
                             % (h, hkv, d, causal, window, dtype))
                    _check_flash_errs(errs, variant, dtype, where)
                    for name, e in errs.items():
                        _worst(worst, name + variant, e)
    b, h, l, d = TRAIN_BATCH, 8, FLAGSHIP["seq_len"], 128
    q, k, v = flash_inputs(gen, b, h, h, l, d, torch.bfloat16)
    do = flash_inputs(gen, b, h, h, l, d, torch.bfloat16)[0]
    seg = torch.as_tensor(doc_rows(rng, b, l, 64, 1024)[1]).cuda()
    path = {"window": {"window": WINDOW},
            "segments": {"q_seg": seg, "k_seg": seg}}
    for key, masks in path.items():
        errs, variant = _flash_case(q, k, v, do, True, masks)
        _check_flash_errs(errs, variant, torch.bfloat16,
                          "the path shape (%s)" % key)
        log("masked flash at the path shape, %s: %s" % (key, errs))
        for name, e in errs.items():
            _worst(path_worst, name + variant, e)
    log("masked flash kernels, worst at small shapes: %s" % worst)
    return worst, path_worst, (q, k, v, do, path)


def _paged_case(args, window, t, int8):
    """Kernel B's window variant on one input against the plain version:
    the relative errors of o, l, m, with rows that see no pool row
    required to be exactly (0, 0, -1e30)."""
    if int8:
        args = quantize_pools(args)
    o, l, mx = att.paged_decode_partials(*args, window=window, t=t)
    torch.cuda.synchronize()
    po, pl, pm = att.paged_decode_partials_plain(*args, window=window, t=t)
    dead = pl == 0
    check(bool((o[dead] == 0).all()) and bool((l[dead] == 0).all())
          and bool((mx[dead] == att.NEG_INF).all()),
          "paged window: a row that sees no pool row is not (0, 0, -1e30)")
    check(all(torch.isfinite(x).all().item() for x in (o, l)),
          "paged window: non-finite partials")
    e_abs = max((o - po).abs().max().item(), (l - pl).abs().max().item())
    return partials_errs((o, l, mx), (po, pl, pm)), e_abs, int(dead.sum())


def check_masked_paged(gen):
    """Kernel B's window variants (float and int8 split kernels, float
    and int8 tile kernels) against the plain version. Small shapes: t 1,
    3, 8, 9 and 128 with groups 1, 2 and 4 (row r of the group-major
    query axis is tile token r % t: a wrong map passes every t = 1 case),
    windows shorter than the tile, a length 0 and a -1 hole inside a
    live range, bf16 and int8 arenas. Then the windowed serving path's
    shapes: 8 slots at t = 1 over lengths under 1000 and a 128-row suffix
    tile over a 256-token prefix, window 256. Limits PAGED_TOL_REL (bf16)
    and PAGED_INT8_TOL_REL (int8), those of the unmasked kernels.
    Returns ({variant: worst rel err}, the path shapes' cases)."""
    worst = {}
    dead_rows = 0
    windows = {1: 6, 3: 2, 8: 40, 9: 5, 128: 100}
    for t, window in windows.items():
        for group in (1, 2, 4):
            d, bs = (128, 16) if (t + group) % 2 else (64, 4)
            for int8 in (False, True):
                args, _lens = paged_inputs(
                    gen, b=3, hkv=2, group=group, t=t, d=d, bs=bs, m=8,
                    num_blocks=40, lengths=[bs * 5 + 3, 0, bs * 2 + 1])
                args[3][0, 1] = -1  # a hole inside sequence 0's range
                errs, e_abs, dead = _paged_case(args, window, t, int8)
                dead_rows += dead
                name = ("paged_decode_tile" if group * t > att.SPLIT_MAX_ROWS
                        else "paged_decode") + ("_int8" if int8 else "")
                tol = PAGED_INT8_TOL_REL if int8 else PAGED_TOL_REL
                check(max(errs) <= tol,
                      "%s_window disagrees with its plain version at t=%d "
                      "group=%d window=%d: %s" % (name, t, group, window,
                                                  errs))
                _worst(worst, name + "_window", {
                    "small_shapes_max_rel_err": max(errs),
                    "small_shapes_max_abs_err": e_abs})
    # windows shorter than the tile must have left rows with no pool row
    check(dead_rows > 0, "no windowed row saw an empty pool")
    paged_gen = torch.Generator().manual_seed(PAGED_TIMING_SEED + 1)
    cases = []
    for t, lengths, label in ((1, None, "b=8 t=1"),
                              (128, [256], "b=1 t=128")):
        args, lens = paged_inputs(paged_gen, b=1 if lengths else 8, t=t,
                                  lengths=lengths)
        for int8 in (False, True):
            errs, e_abs, _dead = _paged_case(args, WINDOW, t, int8)
            name = ("paged_decode_tile" if t > att.SPLIT_MAX_ROWS
                    else "paged_decode") + ("_int8" if int8 else "")
            tol = PAGED_INT8_TOL_REL if int8 else PAGED_TOL_REL
            check(max(errs) <= tol,
                  "%s_window disagrees with its plain version at the "
                  "path shape %s: %s" % (name, label, errs))
            _worst(worst, name + "_window",
                   {"max_rel_err": max(errs), "max_abs_err": e_abs,
                    "max_err": e_abs})
            cases.append((name + "_window", t, label, args, lens, int8))
    log("paged window kernels, worst rel err: %s (%d empty rows); limits "
        "%g (bf16), %g (int8)" % (worst, dead_rows, PAGED_TOL_REL,
                                  PAGED_INT8_TOL_REL))
    return worst, cases


def drive_engine(engine, requests):
    """Seat requests in order as slots and blocks allow, step until every
    one has finished; returns their generated tokens."""
    pending = list(requests)
    for _ in range(10_000):
        while pending and engine.free_slots() and engine.can_seat(
                pending[0]):
            engine.insert(pending.pop(0))
        if not pending and not engine.active_count():
            break
        engine.step()
    check(not pending and not engine.active_count(), "engine did not drain")
    return [list(r.generated) for r in requests]


def compare_windowed_streams(rng):
    """A small windowed fp32 model (SMALL_WINDOWED, numpy weights) served
    through the paged engine on the card and on the CPU: 8 greedy
    requests with prompts of 40-120 tokens (longer than the window of
    32), 4 of them on a shared 64-token prefix (suffix tiles of more than
    8 rows over resident blocks); the streams must be equal, and the
    card run must go through the windowed split and tile kernels."""
    from elasticdl_tpu_torch.serving.admission import ServingRequest
    from elasticdl_tpu_torch.serving.engine import (
        PagedContinuousBatchingEngine,
    )

    cfg = SMALL_WINDOWED
    sd = params_from_flax(numpy_flax_params(cfg, seed=5))
    vocab = cfg["vocab_size"]
    prefix = rng.randint(0, vocab, size=64).tolist()
    specs = []
    for i in range(8):
        p_len = int(rng.randint(74 if i % 2 == 0 else 40, 121))
        prompt = (prefix + rng.randint(0, vocab, size=p_len - 64).tolist()
                  if i % 2 == 0 else rng.randint(0, vocab,
                                                 size=p_len).tolist())
        specs.append((prompt, int(rng.randint(16, 33))))
    streams = {}
    for dev in ("cuda", "cpu"):
        model = TransformerLM(device=dev, **cfg)
        model.load_state_dict(sd)
        engine = PagedContinuousBatchingEngine(model, 4, block_size=16)
        att.reset_launch_counts()
        streams[dev] = drive_engine(engine, [ServingRequest(p, n)
                                             for p, n in specs])
        if dev == "cuda":
            launches = dict(att.KERNEL_LAUNCHES)
    for name in ("flash_fwd_window", "paged_decode_window",
                 "paged_decode_tile_window"):
        check(launches[name] > 0, "the small windowed model's card run did "
              "not launch %s" % name)
    equal = streams["cuda"] == streams["cpu"]
    log("small windowed model, card vs cpu greedy streams equal: %s" % equal)
    check(equal, "windowed greedy streams differ between the card and the "
          "CPU: %s / %s" % (streams["cuda"], streams["cpu"]))
    return {"requests": len(specs), "tokens": sum(map(len, streams["cuda"])),
            "streams_equal": equal, "config": {
                k: v for k, v in cfg.items()}, "launches": {
                k: v for k, v in launches.items() if v}}


def compare_packed_rows(rng):
    """A packed row's logits against those of each of its documents run
    alone, on the card at the flagship width (2 layers, fp32, seeded
    weights): the row of pack_sequences over documents of 32-400 tokens
    that holds the most documents. Within PACKED_LOGIT_TOL_REL of the
    largest logit."""
    cfg = dict(FLAGSHIP, num_layers=2, dtype=torch.float32)
    model = TransformerLM(device="cuda", seed=2, **cfg).requires_grad_(False)
    tokens, seg, labels = doc_rows(rng, 1, cfg["seq_len"], 32, 400,
                                   most_docs=True)
    dev = model.device
    with torch.no_grad():
        packed = model({"tokens": torch.as_tensor(tokens, device=dev),
                        "segment_ids": torch.as_tensor(seg, device=dev)})
        worst, docs = 0.0, 0
        for sid in np.unique(seg[0]):
            span = np.flatnonzero(seg[0] == sid)
            if not (labels[0][span] != packing.IGNORE_LABEL).any():
                continue  # the pad tail
            alone = model({"tokens": torch.as_tensor(tokens[:, span],
                                                     device=dev)})
            err = rel_err(packed[0, span[0]:span[-1] + 1], alone[0])
            worst, docs = max(worst, err), docs + 1
    log("packed row vs its %d documents alone (fp32, flagship width): rel "
        "err %.3g" % (docs, worst))
    check(docs >= 2, "the packed row holds %d documents" % docs)
    check(worst <= PACKED_LOGIT_TOL_REL,
          "a packed row's logits differ from its documents' by %.3g of the "
          "largest logit" % worst)
    return {"documents": docs, "max_rel_err": worst,
            "limit_rel": PACKED_LOGIT_TOL_REL}


def _step_metrics(step_ms, batch, seq, real, peak_bytes):
    flops = transformer_flops_per_step(
        batch, seq, FLAGSHIP["embed_dim"], FLAGSHIP["num_layers"],
        FLAGSHIP["vocab_size"])
    share = real / (batch * seq)
    return {
        "step_ms_p50": step_ms,
        "tokens_per_s": batch * seq / (step_ms / 1e3),
        "real_tokens_per_step": real, "real_token_share": share,
        "real_tokens_per_s": real / (step_ms / 1e3),
        "mfu_real_tokens": flops * share / (step_ms / 1e3) / PEAK_BF16_FLOPS,
        "peak_memory_bytes": peak_bytes,
    }


def _check_step_launches(steps, kernels, what):
    layers = FLAGSHIP["num_layers"]
    for i, s in enumerate(steps):
        for name, count in s.items():
            want = layers if name in kernels else 0
            check(count == want, "%s step %d launched %s %d times, not %d"
                  % (what, i, name, count, want))


def _write_doc_records(path, n, rng):
    """n documents of 4-48 tokens (gen_docs_like's records: "tokens" and
    "vocab_size") through the port's writer."""
    vocab = FLAGSHIP["vocab_size"]
    with RecordWriter(path) as w:
        for _ in range(n):
            w.write(encode_example({
                "tokens": rng.randint(0, vocab, size=rng.randint(4, 49))
                .astype(np.int64),
                "vocab_size": np.array(vocab, np.int64)}))


def train_packed_family(rng, workdir):
    """The packed family (transformer_lm_packed, seq_len ROW_LEN = 128)
    at the flagship width through LocalExecutor (minibatch 8, 4 steps)
    over PACKED_DOCS document records written by the port's RecordWriter:
    finite losses, the first within 0.5 of ln(vocab) + 1/2, and kernels
    A, C, D launched in their segment variants once per layer in every
    step, the unmasked ones never; then the last batch's steps profiled
    (the launches are read before)."""
    data = os.path.join(workdir, "docs")
    os.makedirs(data)
    _write_doc_records(os.path.join(data, "docs-00000.trec"), PACKED_DOCS,
                       rng)
    cfg = dict(FLAGSHIP, seq_len=tpacked.ROW_LEN)
    executor = LocalExecutor(
        load_model_spec_from_module(tpacked), training_data=data,
        minibatch_size=PACKED_BATCH, max_steps=PACKED_STEPS,
        records_per_task=PACKED_DOCS, model_params=_params_str(cfg),
        device="cuda")
    steps, batches = [], []
    step_fn = executor.trainer.train_step

    def timed_step(state, batch, true_count=None):
        before = dict(att.KERNEL_LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(state, batch, true_count)
        torch.cuda.synchronize()
        batches.append(batch)
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "real": real_tokens(batch[0]["segment_ids"], batch[1]),
                      "launches": {k: att.KERNEL_LAUNCHES[k] - before[k]
                                   for k in att.KERNEL_LAUNCHES}})
        return out

    executor.trainer.train_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    att.reset_launch_counts()
    state, _ = executor.train()
    torch.cuda.synchronize()
    launches = dict(att.KERNEL_LAUNCHES)
    del executor.trainer.train_step
    losses = executor.losses
    log("packed family losses: %s; step ms %s" % (
        losses, [round(s["ms"], 2) for s in steps]))
    check(state is not None and len(losses) == PACKED_STEPS,
          "the packed family took %d steps, not %d" % (len(losses),
                                                       PACKED_STEPS))
    check(all(math.isfinite(x) for x in losses), "non-finite packed loss")
    expected = math.log(FLAGSHIP["vocab_size"]) + 0.5
    check(abs(losses[0] - expected) <= 0.5,
          "packed family: first loss %.4f is not within 0.5 of %.4f"
          % (losses[0], expected))
    kernels = masked_training_kernels("segments")
    _check_step_launches([s["launches"] for s in steps], kernels,
                         "packed family")
    step_ms = float(np.percentile([s["ms"] for s in steps[1:]], 50))
    real = int(np.mean([s["real"] for s in steps]))
    metrics = {
        "model": "transformer_lm_packed at flagship width, bf16 compute",
        "minibatch": PACKED_BATCH, "seq_len": tpacked.ROW_LEN,
        "documents": PACKED_DOCS, "steps": PACKED_STEPS,
        "step_ms": [s["ms"] for s in steps],
        **_step_metrics(step_ms, PACKED_BATCH, tpacked.ROW_LEN, real,
                        int(torch.cuda.max_memory_allocated())),
        "losses": losses, "expected_first_loss": expected,
        "launches_per_step": {k: steps[-1]["launches"][k] for k in kernels},
        "step_profile": profile_steps(executor.trainer, state, batches[-1]),
    }
    return metrics, launches


def train_packed_flagship(rng):
    """transformer_lm at the flagship width and seq_len 1024, minibatch 8,
    through Trainer.train_step on packed rows with the flagship's AdamW:
    first the port's pack_sequences over documents of 64-1024 tokens (a
    ragged number of segments per row, pad tails, cross-document labels
    -100), then bench.py's packed=4 layout (four equal segments per row,
    labels the shifted tokens, bench.py:307-313). PACKED_WARM +
    PACKED_TIMED steps per layout, the segment variants once per layer
    in every step; then 2 profiled steps for the device's busy share."""
    b, l = TRAIN_BATCH, FLAGSHIP["seq_len"]
    vocab = FLAGSHIP["vocab_size"]
    trainer = Trainer(load_model_spec_from_module(tzoo),
                      model_params=_params_str(FLAGSHIP), device="cuda")
    state = trainer.init_state(None)
    tokens, seg, labels = doc_rows(rng, b, l, 64, 1024)
    ragged = ({"tokens": tokens, "segment_ids": seg}, labels)
    toks = rng.randint(0, vocab, size=(b, l + 1)).astype(np.int32)
    seg4 = np.minimum(np.arange(l) * 4 // l, 3).astype(np.int32)
    packed4 = ({"tokens": toks[:, :-1],
                "segment_ids": np.broadcast_to(seg4, (b, l)).copy()},
               toks[:, 1:])
    kernels = masked_training_kernels("segments")
    out, all_launches = {}, {}
    for name, batch, real in (
            ("ragged", ragged, real_tokens(seg, labels)),
            ("packed4", packed4, b * l)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        att.reset_launch_counts()
        times, losses, per_step = [], [], []
        for _ in range(PACKED_WARM + PACKED_TIMED):
            before = dict(att.KERNEL_LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            per_step.append({k: att.KERNEL_LAUNCHES[k] - before[k]
                             for k in att.KERNEL_LAUNCHES})
        all_launches[name] = dict(att.KERNEL_LAUNCHES)
        peak = int(torch.cuda.max_memory_allocated())
        _check_step_launches(per_step, kernels, "packed flagship " + name)
        check(all(math.isfinite(x) for x in losses),
              "non-finite packed flagship loss")
        if name == "ragged":
            expected = math.log(vocab) + 0.5
            check(abs(losses[0] - expected) <= 0.5,
                  "packed flagship: first loss %.4f is not within 0.5 of "
                  "%.4f" % (losses[0], expected))
        step_ms = float(np.percentile(times[PACKED_WARM:], 50))
        out[name] = {
            "layout": ("pack_sequences over documents of 64-1024 tokens"
                       if name == "ragged" else
                       "bench.py packed=4: four equal segments per row"),
            "documents_per_row": docs_per_row(batch[0]["segment_ids"],
                                              batch[1]).tolist(),
            "minibatch": b, "seq_len": l,
            "steps": "%d warm + %d timed" % (PACKED_WARM, PACKED_TIMED),
            "step_ms": times, "losses": losses,
            **_step_metrics(step_ms, b, l, real, peak),
            "step_profile": profile_steps(trainer, state, batch),
            "launches_per_step": {k: per_step[-1][k] for k in kernels},
        }
        log("packed flagship %s: %s" % (name, json.dumps(
            {k: v for k, v in out[name].items() if k != "step_profile"})))
    return out, all_launches


def visible_pairs(l, window=None, seg=None):
    """Causal (query, key) pairs one head sees over l rows: each row of a
    window sees min(i + 1, window) keys; a packed row sees n(n + 1) / 2
    pairs per document of n tokens. Summed over the batch rows of
    `seg` [b, l] (one row without segments)."""
    if seg is None:
        w = window or l
        return sum(min(i + 1, w) for i in range(l))
    seg = np.asarray(seg)
    total = 0
    for row in seg:
        _ids, counts = np.unique(row, return_counts=True)
        total += int(sum(n * (n + 1) // 2 for n in counts))
    return total


def sdpa_masked_ms(q, k, v, do, mask):
    """(forward ms, backward ms) of F.scaled_dot_product_attention with
    the boolean mask `mask` (True = attend): the yardstick of the masked
    flash kernels, timed eagerly between CUDA events, never on a path.
    The backward is forward + backward less the forward."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(*leaves, attn_mask=mask)

    def fwd_bwd():
        torch.autograd.grad(fwd(), leaves, do)

    with torch.no_grad():
        fwd()
    fwd_bwd()
    torch.cuda.synchronize()
    with torch.no_grad():
        fwd_ms = _events_ms(fwd, 20)
    return fwd_ms, _events_ms(fwd_bwd, 10) - _events_ms(fwd, 10)


def time_masked_flash(flash_inputs_path, launches, errors):
    """Kernels A, C and D's window and segment variants at the training
    path's shape (b = 8, h = 8, l = 1024, d = 128, causal, bf16; window
    256, or pack_sequences' segments), each against a bound over the
    pairs its mask keeps, its plain version, and SDPA with the same
    boolean mask. `launches`: {variant: count on its path}."""
    q, k, v, do, path = flash_inputs_path
    b, h, l, d = q.shape
    entries = []
    for key, masks in path.items():
        seg = masks.get("q_seg")
        pairs = (visible_pairs(l, window=masks.get("window")) * b
                 if seg is None else visible_pairs(l, seg=seg.cpu()))
        mask = att._visible(l, l, True, masks.get("window"), seg, seg,
                            device=q.device)
        lib_fwd, lib_bwd = sdpa_masked_ms(q, k, v, do, mask)
        out, lse = att.flash_forward(q, k, v, causal=True, **masks)
        _dq, delta = att.flash_backward_dq(q, k, v, out, lse, do,
                                           causal=True, **masks)
        shape = "b=%d h=%d lq=lk=%d d=%d causal bf16, %s" % (
            b, h, l, d, "window %d" % WINDOW if seg is None
            else "pack_sequences segments, %d documents" % len(
                np.unique(seg.cpu().numpy() + np.arange(b)[:, None] * l)))
        seg_bytes = 0 if seg is None else 2 * 4 * b * l
        rows_q, rows_kv = b * h * l, b * h * l
        io = 2 * d  # bf16 bytes of one row of d
        for name, line, fn, plain, flops, nbytes, lib in (
                ("flash_fwd", 941,
                 lambda: att.flash_forward(q, k, v, causal=True, **masks),
                 lambda: att.flash_attention_plain(q, k, v, causal=True,
                                                   bf16_operands=True,
                                                   **masks),
                 4 * d * pairs * h, io * (2 * rows_q + 2 * rows_kv)
                 + 4 * rows_q, lib_fwd),
                ("flash_bwd_dq", 1241,
                 lambda: att.flash_backward_dq(q, k, v, out, lse, do,
                                               causal=True, **masks),
                 lambda: att.flash_backward_dq_plain(q, k, v, out, lse, do,
                                                     causal=True, **masks),
                 6 * d * pairs * h, io * (4 * rows_q + 2 * rows_kv)
                 + 8 * rows_q, lib_bwd),
                ("flash_bwd_dkv", 1294,
                 lambda: att.flash_backward_dkv(q, k, v, do, lse, delta,
                                                causal=True, **masks),
                 lambda: att.flash_backward_dkv_plain(q, k, v, do, lse,
                                                      delta, causal=True,
                                                      **masks),
                 8 * d * pairs * h, io * (2 * rows_q + 4 * rows_kv)
                 + 8 * rows_q, lib_bwd)):
            variant = "%s_%s" % (name, key)
            entry = _timing_entry(
                variant, "elasticdl_tpu_torch/csrc/%s.cu" % (
                    "flash_fwd" if name == "flash_fwd" else "flash_bwd"),
                "elasticdl_tpu/ops/attention.py:%d (%s)" % (
                    line, "_block_mask window" if seg is None
                    else "has_segs"),
                shape, fn, plain,
                (lib, "F.scaled_dot_product_attention with the same "
                 "boolean mask, %s (eager)" % (
                     "forward" if name == "flash_fwd" else
                     "forward + backward less forward: dq, dk and dv")),
                (flops, nbytes + seg_bytes), launches,
                dict(errors.get(variant, {}),
                     max_err=errors.get(variant, {}).get("max_abs_err")))
            entry["visible_pairs_per_head"] = pairs
            entry["causal_pairs_per_head"] = b * l * (l + 1) // 2
            entries.append(entry)
    return entries


def paged_window_work(lengths, hkv, n_rows, t, d, itemsize, m, window,
                      int8=False):
    """(operations, bytes) of one windowed paged partials call over the
    pairs its mask keeps: tile token r % t sees min(length, window -
    r % t - 1) pool rows, 4*d operations each; the rows any query row
    sees (those of token 0) are read once per kv head, with their
    scales for int8; fp32 query rows and partials move once, plus the
    table and lengths."""
    pairs = rows = 0
    for length in lengths:
        rows += min(length, window - 1)
        pairs += sum(min(length, max(0, window - r % t - 1))
                     for r in range(n_rows))
    b = len(lengths)
    flops = 4 * d * hkv * pairs
    nbytes = (2 * (itemsize * d + (4 if int8 else 0)) * hkv * rows
              + 4 * b * hkv * n_rows * (2 * d + 2) + 4 * b * (m + 1))
    return flops, nbytes


def time_masked_paged(cases, launches, errors):
    """Kernel B's window variants at the windowed serving path's shapes
    (check_masked_paged's cases): the 8-slot decode step and a 128-row
    suffix tile over a 256-token prefix, window 256, bf16 or int8
    arenas. The bound counts the pairs inside the window."""
    entries = []
    for name, t, label, args, lens, int8 in cases:
        call_args = quantize_pools(args) if int8 else args
        entries.append(paged_cold(_timing_entry(
            name, "elasticdl_tpu_torch/csrc/paged_decode.cu",
            "elasticdl_tpu/ops/attention.py:591 (window, :355-374 "
            "_paged_valid%s)" % (", int8 branch :613-634" if int8 else ""),
            "%s hkv=8 d=128 bs=16 m=64 %s, window %d, live rows %d"
            % (label, "int8 + fp32 row scales" if int8 else "bf16", WINDOW,
               sum(lens)),
            lambda a=call_args, t=t: att.paged_decode_partials(
                *a, window=WINDOW, t=t),
            lambda a=call_args, t=t: att.paged_decode_partials_plain(
                *a, window=WINDOW, t=t),
            None, paged_window_work(lens, 8, t, t, 128, 1 if int8 else 2,
                                    64, WINDOW, int8=int8),
            launches, dict(errors.get(name, {})), peak=PEAK_FP32_FLOPS),
            args, window=WINDOW, t=t, int8=int8))
    return entries


# ---------------------------------------------- context parallelism (sp)

SP = 4  # rank processes of the sp path; they share the one card
SP_SEQ = 4096  # global sequence: each rank holds 1024 tokens
SP_LOCAL = SP_SEQ // SP
SP_BATCH, SP_STEPS = 2, 2
SP_WINDOW = 1536  # the windowed ring reaches 0, 1 and 2 shards back
SP_SEED = 21
# name: the model params each sp run adds to the flagship
SP_CONFIGS = {"ring": {"sp_impl": "ring"},
              "ring_window": {"sp_impl": "ring", "attn_window": SP_WINDOW},
              "ulysses": {"sp_impl": "ulysses"}}
# the single-device run each sp run is held against
SP_SINGLE = {"ring": "causal", "ring_window": "window", "ulysses": "causal"}
# a bf16 sp step against the single-device step on the same global batch
# and params: the loss by relative error (bf16 rounding at other places:
# the ring merges per-shard partials, Ulysses transposes; the limit of
# the card-vs-CPU bf16 step)
SP_LOSS_TOL_REL = STEP_LOSS_TOL_REL
# a small fp32 windowed ring step on the card against the same step on
# the CPU (plain versions), TF32 off: the loss and each parameter's
# summed gradient norm by relative error (fp32 sums in another order)
SP_SMALL = dict(vocab_size=4096, seq_len=512, embed_dim=256, num_heads=2,
                num_layers=2, attn_window=160)
SP_SMALL_TOL_REL = 1e-4
SP_RANK_TIMEOUT_S = 600
# the ring path's rotations checked and timed alone (b 2, h 8, 1024-row
# shards, d 128, window 1536): offsets 1 and 2 shards back, and one
# newer shard of the non-causal band
SP_PATH_OFFSETS = ((SP_LOCAL, False), (2 * SP_LOCAL, False),
                   (-SP_LOCAL, False))
# the runs phase 20's rank processes add after the sp configurations: the
# flagship through LocalExecutor on a dp x sp mesh with a checkpoint every
# step (against the single-device causal run), the causal ring with the
# fused head on the sp mesh (against the single-device fused run), and
# BERT-base on the dp x sp mesh (against its single-device run)
DP_SP_MESH = {"dp": 2, "sp": 2}
DP_SP = DP_SP_MESH["dp"] * DP_SP_MESH["sp"]
FUSED_EXTRA = {"sp_impl": "ring", "fused_head": True}
BERT_SP_SEED = 29
# kernels C and D at bert's ring rotation shape on the dp x sp mesh (b 8
# rows a dp rank, h 12, 256-row shards, d 64, bf16 in, fp32 gradients)
BERT_RING_SHAPE = (8, 12, 256, 64)


def ring_launches(extra, sp, dp, layers, seq, causal=True):
    """{kernel variant: launches in one training step summed over the dp
    x sp ranks} from the ring's own rotation table: each rotation that
    runs is one forward, one dq and one dk/dv launch per layer, under
    "_window" for a windowed ring and "_offset" when its pos_offset is
    nonzero; Ulysses launches each kernel once per layer and rank over
    the whole sequence. Each dp replica runs its own ring."""
    local = seq // sp
    counts = {}
    if extra.get("sp_impl") == "ulysses":
        calls = [{"window": None, "pos_offset": 0}] * sp
    else:
        calls = [cp.rotation_call(src, my, sp, local, causal,
                                  extra.get("attn_window"))
                 for my in range(sp) for src in range(sp)]
    for call in calls:
        if call is None:
            continue
        for base in TRAINING_KERNELS:
            name = att._variant(base, call["window"], False,
                                call["pos_offset"] != 0)
            counts[name] = counts.get(name, 0) + layers * dp
    return counts


def sp_expected_launches(config):
    """ring_launches of one of SP_CONFIGS on the SP ranks."""
    return ring_launches(SP_CONFIGS[config], SP, 1, FLAGSHIP["num_layers"],
                         SP_SEQ)


def sp_batch():
    """The global batch every rank is given: [SP_BATCH, SP_SEQ] tokens."""
    rs = np.random.RandomState(SP_SEED)
    tokens = rs.randint(0, FLAGSHIP["vocab_size"],
                        size=(SP_BATCH, SP_SEQ + 1)).astype(np.int32)
    return {"tokens": tokens[:, :-1]}, tokens[:, 1:]


def sp_params():
    """The flagship's params at seq_len SP_SEQ, drawn by numpy: every
    rank, and the single-device run, loads the same."""
    cfg = dict(FLAGSHIP, seq_len=SP_SEQ)
    return params_from_flax(numpy_flax_params(cfg, seed=SP_SEED))


def _param_digest(params):
    digest = hashlib.sha256()
    for key in sorted(params):
        digest.update(params[key].detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def _counted_step(step_fn, state, batch, mesh, true_count=None):
    """One `step_fn` train step on the card with the attention kernels'
    counts set to 0 just before it: (state, {"loss", "ms" (host clock),
    "launches", "peak_bytes" (the most allocated on the card during the
    step), under a mesh "digest" of the parameters after it})."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    att.reset_launch_counts()
    t0 = time.perf_counter()
    state, loss = step_fn(state, batch, true_count)
    torch.cuda.synchronize()
    step = {"loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
            "launches": {k: n for k, n in att.KERNEL_LAUNCHES.items()
                         if n},
            "peak_bytes": int(torch.cuda.max_memory_allocated())}
    if mesh is not None:
        step["digest"] = _param_digest(state.params)
    return state, step


def _train_steps(trainer, state, batch, mesh):
    """SP_STEPS _counted_step steps on one batch, after the digest of the
    starting parameters under a mesh."""
    steps = [{"digest": _param_digest(state.params)}] if mesh else []
    for _ in range(SP_STEPS):
        state, step = _counted_step(trainer.train_step, state, batch, mesh)
        steps.append(step)
    return steps


def sp_train(params, batch, extra, mesh=None):
    """SP_STEPS Trainer steps of the flagship at SP_SEQ on the card,
    under `mesh` (this rank's part of a mesh run) or on one device.
    Returns per step the loss, the host-clock ms, the kernel launches
    and peak allocation of the step and (under a mesh) the digest of
    the parameters."""
    cfg = dict(FLAGSHIP, seq_len=SP_SEQ, **extra)
    trainer = Trainer(load_model_spec_from_module(tzoo), mesh=mesh,
                      model_params=_params_str(cfg), device="cuda")
    state = trainer.init_state(batch, params=params)
    steps = _train_steps(trainer, state, batch, mesh)
    del trainer, state
    torch.cuda.empty_cache()
    return steps


def bert_sp_batch():
    """BERT-base's global batch for phase 20 (phase 33's width and
    minibatch): masked rows drawn by numpy."""
    _model_def, cfg, n = ENC_MODELS["bert"]
    rs = np.random.RandomState(BERT_SP_SEED)
    tokens = rs.randint(0, cfg["vocab_size"], size=(n, cfg["seq_len"]))
    masked, mlm = zip(*[bert_zoo._mask_tokens(row.astype(np.int32),
                                              cfg["vocab_size"], rs)
                        for row in tokens])
    return {"tokens": np.stack(masked)}, np.stack(mlm)


def bert_sp_train(mesh=None):
    """SP_STEPS Trainer steps of BERT-base (bf16 over fp32 params, its
    seeded init on the card, the same in every process) on bert_sp_batch,
    under `mesh` or on one device: sp_train's records."""
    model_def, cfg, _n = ENC_MODELS["bert"]
    trainer = Trainer(get_model_spec(_tab_zoo_dir(), model_def), mesh=mesh,
                      model_params=_dlrm_params_str(cfg), seed=BERT_SP_SEED,
                      device="cuda")
    batch = bert_sp_batch()
    state = trainer.init_state(batch)
    steps = _train_steps(trainer, state, batch, mesh)
    del trainer, state
    torch.cuda.empty_cache()
    return steps


def dp_sp_run(params, batch, mesh, workdir):
    """This rank's part of the flagship at SP_SEQ through LocalExecutor
    on the dp x sp `mesh`: SP_STEPS steps (one task of `batch`'s rows an
    epoch, from `params`) with a checkpoint every step into
    workdir/dp_sp_ckpt, which world rank 0 alone writes. Then version 1
    restored on every rank into a fresh Trainer on the mesh and step 2
    replayed on the batch the executor fed it. Returns the steps
    (_counted_step's records), whether this rank wrote, the versions on
    disk, and the restored and replayed parameters' digests."""
    data = os.path.join(workdir, "dp_sp_records_rank%d" % mesh.world_rank)
    os.makedirs(data)
    with RecordWriter(os.path.join(data, "tokens-00000.trec")) as w:
        for f, lab in zip(batch[0]["tokens"], batch[1]):
            w.write(encode_example({"tokens": np.concatenate(
                [f, lab[-1:]]).astype(np.int64)}))
    ckpt = os.path.join(workdir, "dp_sp_ckpt")
    cfg = dict(FLAGSHIP, seq_len=SP_SEQ, sp_impl="ring")
    spec = load_model_spec_from_module(tzoo)
    executor = LocalExecutor(
        spec, training_data=data, minibatch_size=SP_BATCH,
        num_epochs=SP_STEPS, records_per_task=SP_BATCH,
        model_params=_params_str(cfg), checkpoint_dir=ckpt,
        checkpoint_steps=1, device="cuda", mesh=mesh)
    trainer = executor.trainer
    executor.state = trainer.init_state(batch, params=params)
    steps, fed = [{"digest": _param_digest(executor.state.params)}], []
    step_fn = trainer.train_step

    def counted(state, batch_, true_count=None):
        fed.append((batch_, true_count))
        state, step = _counted_step(step_fn, state, batch_, mesh, true_count)
        steps.append(step)
        return state, step["loss"]

    trainer.train_step = counted
    executor.train()
    del trainer.train_step
    out = {"steps": steps,
           "wrote": bool(executor.checkpoint_saver.last_timing),
           "versions": sorted(os.listdir(ckpt)),
           "losses": list(executor.losses)}
    # the saver's flatten leaves the trainer in reference cycles on rank 0:
    # collect them, so the later runs' peaks are alike on every rank
    del executor, trainer
    gc.collect()
    torch.cuda.empty_cache()
    replay = Trainer(spec, mesh=mesh, model_params=_params_str(cfg),
                     device="cuda")
    state = replay.init_state(batch)
    state, version = restore_state_from_checkpoint(replay, state, ckpt,
                                                   version=1)
    out["restored_version"] = version
    out["restored_digest"] = _param_digest(state.params)
    state, loss = replay.train_step(state, *fed[1])
    out["replayed_digest"] = _param_digest(state.params)
    out["replayed_loss"] = loss
    del replay, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sp_small_step(mesh, device):
    """One windowed ring step of SP_SMALL in fp32 on `device` under
    `mesh`: the loss and each parameter's summed gradient norm."""
    batch_rs = np.random.RandomState(SP_SEED + 1)
    tokens = batch_rs.randint(0, SP_SMALL["vocab_size"], size=(
        2, SP_SMALL["seq_len"] + 1)).astype(np.int32)
    batch = ({"tokens": tokens[:, :-1]}, tokens[:, 1:])
    cfg = dict(SP_SMALL, dtype="fp32", sp_impl="ring")
    trainer = Trainer(load_model_spec_from_module(tzoo), mesh=mesh,
                      model_params="; ".join("%s=%r" % kv
                                             for kv in cfg.items()),
                      device=device)
    state = trainer.init_state(batch, params=params_from_flax(
        numpy_flax_params(SP_SMALL, seed=SP_SEED + 2)))
    state, loss = trainer.train_step(state, batch)
    return {"loss": loss, "grad_norms": {
        k: p.grad.float().norm().item() for k, p in state.params.items()}}


GATE_WAIT_S = 1500  # bound on an early child's wait for its go file


def _gate(go_path, tag):
    """In a child the script started early: make the CUDA context, say
    ready (`<go_path>.ready-<tag>`), then wait for the parent's go file
    (at most GATE_WAIT_S) and return its text. The child's timed work
    starts after it."""
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with open("%s.ready-%s" % (go_path, tag), "w") as f:
        f.write("%.6f" % time.time())
    deadline = time.monotonic() + GATE_WAIT_S
    while not os.path.exists(go_path):
        if time.monotonic() > deadline:
            raise SystemExit("no go file %s in %d s" % (go_path,
                                                        GATE_WAIT_S))
        time.sleep(0.05)
    with open(go_path) as f:
        return f.read()


def _go(go_path, text):
    """The parent's side of _gate: the go file, written whole."""
    with open(go_path + ".tmp", "w") as f:
        f.write(text)
    os.replace(go_path + ".tmp", go_path)


def sp_rank_main(rank, go_path, outdir):
    """One rank of the sp path (`chip_smoke.py --sp-rank R GO DIR`),
    started early: its CUDA context made, it waits for the go file GO,
    which names the gloo group's port; then joins the gloo group of SP
    processes on this card, runs every SP_CONFIGS run, the small
    card-vs-CPU step, the fused-head ring (FUSED_EXTRA), the flagship
    through LocalExecutor on DP_SP_MESH with checkpoints (dp_sp_run) and
    BERT-base on DP_SP_MESH, and writes its results and its stages' wall
    clock to DIR/rank<R>.json. The parent built the kernels."""
    import torch.distributed as dist

    from elasticdl_tpu_torch.parallel.mesh import build_mesh

    stages = {"imported": time.time()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    # the inputs (numpy draws, untimed) before the gate
    batch, params = sp_batch(), sp_params()
    stages["inputs"] = time.time()
    port = int(_gate(go_path, "rank%d" % rank))
    stages["go"] = time.time()
    dist.init_process_group("gloo", init_method="tcp://localhost:%d" % port,
                            world_size=SP, rank=rank,
                            timeout=timedelta(seconds=SP_RANK_TIMEOUT_S))
    stages["gloo"] = time.time()
    try:
        mesh = build_mesh({"sp": SP})
        result = {"rank": rank, "configs": {}, "stages": stages}
        for name, extra in SP_CONFIGS.items():
            result["configs"][name] = sp_train(params, batch, extra, mesh)
            stages[name] = time.time()
        result["small"] = {}
        for dev in ("cuda", "cpu"):
            result["small"][dev] = sp_small_step(mesh, dev)
            stages["small_" + dev] = time.time()
        result["fused_ring"] = sp_train(params, batch, FUSED_EXTRA, mesh)
        stages["fused_ring"] = time.time()
        mesh = build_mesh(DP_SP_MESH)
        result["dp_sp"] = dp_sp_run(params, batch, mesh, outdir)
        stages["dp_sp"] = time.time()
        del params
        result["bert_dp_sp"] = bert_sp_train(mesh)
        stages["bert_dp_sp"] = time.time()
        with open(os.path.join(outdir, "rank%d.json" % rank), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_sp_ranks():
    """Start the SP rank processes (the script starts them early, beside
    the kernel checks): each imports torch, makes its CUDA context and
    waits at its gate. Returns the handle run_sp_ranks takes."""
    outdir = tempfile.mkdtemp(prefix="sp_ranks_")
    go = os.path.join(outdir, "go")
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    procs, logs = [], []
    t_spawn = time.time()
    for r in range(SP):
        logs.append(open(os.path.join(outdir, "rank%d.log" % r), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sp-rank",
             str(r), go, outdir], env=env, stdout=logs[-1],
            stderr=subprocess.STDOUT))
    return {"outdir": outdir, "go": go, "procs": procs, "logs": logs,
            "t_spawn": t_spawn}


def _gated_ready(go, tags, procs, what):
    """Wait until every early child of `tags` is at its gate; returns the
    seconds from the spawn to the last one's ready stamp."""
    deadline = time.monotonic() + GATE_WAIT_S
    while True:
        stamps = []
        for tag in tags:
            path = "%s.ready-%s" % (go, tag)
            if os.path.exists(path):
                with open(path) as f:
                    text = f.read()
                if text:
                    stamps.append(float(text))
        if len(stamps) == len(tags):
            return max(stamps)
        check(all(p.poll() is None for p in procs)
              and time.monotonic() < deadline, "%s did not reach its "
              "gate: rcs %s" % (what, [p.poll() for p in procs]))
        time.sleep(0.05)


def close_sp_ranks(handle):
    for proc in handle["procs"]:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    for f in handle["logs"]:
        f.close()
    shutil.rmtree(handle["outdir"], ignore_errors=True)


def run_sp_ranks(handle, meanwhile):
    """Let the SP rank processes of `handle` (start_sp_ranks) go, run
    `meanwhile()` here while they work, wait for them (SP_RANK_TIMEOUT_S
    from the go) and return (their results by rank, what `meanwhile`
    returned); a rank that fails or times out fails the phase, and every
    rank still running is killed."""
    outdir, procs = handle["outdir"], handle["procs"]
    _go(handle["go"], str(_free_port()))
    deadline = time.monotonic() + SP_RANK_TIMEOUT_S
    try:
        done = meanwhile()
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        for f in handle["logs"]:
            f.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * SP:
        tails = []
        for r in range(SP):
            with open(os.path.join(outdir, "rank%d.log" % r)) as f:
                tails.append("rank %d:\n%s" % (r, f.read()[-3000:]))
        raise SmokeFailure("sp rank processes exited %s\n%s"
                           % (codes, "\n".join(tails)))
    results = []
    for r in range(SP):
        with open(os.path.join(outdir, "rank%d.json" % r)) as f:
            results.append(json.load(f))
    return results, done


def check_bert_ring_rotation(gen):
    """Kernels A, C and D at bert's ring rotation shape on DP_SP_MESH
    (BERT_RING_SHAPE: b 8, h 12, 256-row shards, d 64, bf16 in, not
    causal) against their plain versions, C and D writing fp32 gradients
    (the d-64 grad_f32 instances the non-causal ring launches) from a
    ring-like global lse (the rotation's merged with the other shard's).
    Limits: fwd_ok for A, BWD_TOL_REL[bf16] and rounded_ok for C and D
    (_check_flash_errs)."""
    b, h, n, d = BERT_RING_SHAPE
    q, k, v = flash_inputs(gen, b, h, h, n, d, torch.bfloat16)
    do = flash_inputs(gen, b, h, h, n, d, torch.bfloat16)[0]
    _q2, k2, v2 = flash_inputs(gen, b, h, h, n, d, torch.bfloat16)
    _o, lse_other = att.flash_forward(q, k2, v2, causal=False)
    _o, lse_rot = att.flash_forward(q, k, v, causal=False)
    errs, variant = _flash_case(q, k, v, do, False, {},
                                grad_dtype=torch.float32,
                                lse_bwd=torch.logaddexp(lse_rot, lse_other))
    where = "bert's ring rotation shape (b %d, h %d, %d rows, d %d)" % (
        b, h, n, d)
    _check_flash_errs(errs, variant, torch.bfloat16, where)
    log("flash kernels at %s, fp32 gradients: %s" % (where, errs))
    return {"shape": "b=%d h=%d shard=%d d=%d bf16, not causal, fp32 "
            "gradients, ring-like global lse" % (b, h, n, d),
            "errors": errs, "limit_bwd_rel": BWD_TOL_REL[torch.bfloat16]}


def _single_record(steps):
    return {"losses": [s["loss"] for s in steps],
            "step_ms": [s["ms"] for s in steps],
            "peak_bytes": [s["peak_bytes"] for s in steps],
            "launches_per_step": steps[-1]["launches"]}


def check_mesh_steps(name, per_rank, ref, want):
    """The SP_STEPS steps of one mesh run, per rank _counted_step's
    records after the starting digest, against the single-device losses
    `ref`: finite losses, every rank's loss equal, the parameters
    bit-identical across ranks before and after every step, each loss
    within SP_LOSS_TOL_REL of the single device's, each step's launches
    summed over the ranks equal to `want`. Returns the run's record."""
    check(len({r[0]["digest"] for r in per_rank}) == 1,
          "%s: ranks start from different parameters" % name)
    losses = []
    for i in range(SP_STEPS):
        steps = [r[i + 1] for r in per_rank]
        loss = steps[0]["loss"]
        check(math.isfinite(loss), "%s: non-finite loss" % name)
        check(all(s["loss"] == loss for s in steps),
              "%s step %d: ranks disagree on the loss: %s"
              % (name, i, [s["loss"] for s in steps]))
        check(len({s["digest"] for s in steps}) == 1,
              "%s step %d: parameters differ across ranks" % (name, i))
        err = abs(loss - ref[i]) / abs(ref[i])
        check(err <= SP_LOSS_TOL_REL,
              "%s step %d: loss %.6f against the single device's %.6f"
              % (name, i, loss, ref[i]))
        summed = {}
        for s in steps:
            for k, n in s["launches"].items():
                summed[k] = summed.get(k, 0) + n
        check(summed == want, "%s step %d launched %s, not %s"
              % (name, i, summed, want))
        losses.append(loss)
    rec = {"losses": losses, "single_device_losses": ref,
           "loss_max_rel_err": max(abs(a - b) / abs(b)
                                   for a, b in zip(losses, ref)),
           "step_ms_by_rank": [[s["ms"] for s in r[1:]] for r in per_rank],
           "peak_bytes_by_rank": [max(s["peak_bytes"] for s in r[1:])
                                  for r in per_rank],
           "launches_per_step": want}
    log("%s: %s" % (name, json.dumps(rec)))
    return rec


def check_dp_sp(ranks, ref):
    """The flagship through LocalExecutor on DP_SP_MESH (dp_sp_run):
    check_mesh_steps against the single-device causal run, world rank 0
    alone wrote, versions 1 and 2 on disk for every rank, and version 1
    restored on every rank with step 2 replayed bit-identical (sha256 of
    the parameters) to the uninterrupted run's step 2."""
    runs = [r["dp_sp"] for r in ranks]
    layers = FLAGSHIP["num_layers"]
    rec = check_mesh_steps(
        "dp_sp", [run["steps"] for run in runs], ref,
        ring_launches(SP_CONFIGS["ring"], DP_SP_MESH["sp"],
                      DP_SP_MESH["dp"], layers, SP_SEQ))
    wrote = [run["wrote"] for run in runs]
    check(wrote == [True] + [False] * (DP_SP - 1),
          "dp_sp: checkpoint writers by rank %s, not rank 0 alone" % wrote)
    want = ["version-%d" % v for v in range(1, SP_STEPS + 1)]
    for r, run in enumerate(runs):
        check(run["versions"] == want, "dp_sp rank %d sees %s, not %s"
              % (r, run["versions"], want))
        check(run["restored_version"] == 1
              and run["restored_digest"] == run["steps"][1]["digest"],
              "dp_sp rank %d: version 1 restored other parameters than "
              "step 1 left" % r)
        check(run["replayed_digest"] == run["steps"][2]["digest"],
              "dp_sp rank %d: step 2 replayed from version 1 differs from "
              "the uninterrupted step 2" % r)
    rec.update(mesh=DP_SP_MESH, checkpoint_steps=1, writers=wrote,
               versions=want, restored_version=1,
               replay_bit_identical=True,
               replayed_loss=runs[0]["replayed_loss"],
               executor_losses=runs[0]["losses"])
    return rec


def train_sp(early=None):
    """The sp training path: the flagship (vocab 32000, embed 1024, 8
    heads, 8 layers, bf16 over fp32 params, AdamW 3e-4 / wd 0.01) at
    seq_len SP_SEQ, minibatch SP_BATCH, over SP rank processes sharing
    the card through a gloo group, SP_STEPS steps of each of SP_CONFIGS
    (the causal ring, the ring with attn_window SP_WINDOW, Ulysses) and
    of the causal ring with the fused head (FUSED_EXTRA), the flagship
    through LocalExecutor on DP_SP_MESH with a checkpoint every step
    (check_dp_sp) and BERT-base on DP_SP_MESH (phase 33's width and
    minibatch, its non-causal ring at d 64). While the ranks run, this
    process runs the single-device port Trainer on the same global
    batches and params (causal, windowed, fused head, BERT-base). Before
    them, check_bert_ring_rotation. Checks: check_mesh_steps of every
    run against its single-device run (launches per kernel variant from
    ring_launches), check_dp_sp, the small fp32 windowed ring step equal
    card against CPU. Returns the `sp` metrics and the launches of one
    windowed ring step by variant. The step times are no sp speed
    figure: SP processes time-share one card (with the single-device
    references) and exchange through host memory."""
    batch, params = sp_batch(), sp_params()
    bert_ring = check_bert_ring_rotation(
        torch.Generator().manual_seed(BERT_SP_SEED))

    def references():
        single = {}
        for name, extra in (("causal", {}),
                            ("window", {"attn_window": SP_WINDOW}),
                            ("fused", {"fused_head": True})):
            single[name] = _single_record(sp_train(params, batch, extra))
        single["bert"] = _single_record(bert_sp_train())
        for name, run in single.items():
            check(all(math.isfinite(x) for x in run["losses"]),
                  "non-finite single-device %s loss" % name)
        return single

    handle = early or start_sp_ranks()
    try:
        ready_at = _gated_ready(handle["go"], ["rank%d" % r
                                               for r in range(SP)],
                                handle["procs"], "the sp ranks")
        t0 = time.perf_counter()
        ranks, single = run_sp_ranks(handle, references)
        wall = time.perf_counter() - t0
    finally:
        close_sp_ranks(handle)
    del params
    torch.cuda.empty_cache()
    # each rank's seconds by stage, from its go (its gloo join, each
    # configuration, the small step on the card and on the CPU, the
    # fused ring, dp_sp, bert_dp_sp)
    stage_s = []
    for r in ranks:
        st, prev, row = r["stages"], r["stages"]["go"], {}
        for name, t in st.items():
            if name not in ("imported", "inputs", "go"):
                row[name] = t - prev
                prev = t
        stage_s.append(row)
    out = {"model": "transformer_lm flagship, bf16 compute, fp32 params",
           "seq_len": SP_SEQ, "minibatch": SP_BATCH, "sp": SP,
           "shard_len": SP_LOCAL, "steps": SP_STEPS,
           "exchange": "gloo, host-staged (SP processes share one card)",
           "loss": "the zoo's partial form (loss_parts) reduced over the "
                   "mesh; no logits gather",
           "single_device": single, "ranks_wall_s": wall,
           "ranks_spawn_to_ready_s": ready_at - handle["t_spawn"],
           "rank_stage_s": stage_s, "configs": {}}
    for name in SP_CONFIGS:
        out["configs"][name] = dict(SP_CONFIGS[name], **check_mesh_steps(
            "sp %s" % name, [r["configs"][name] for r in ranks],
            single[SP_SINGLE[name]]["losses"], sp_expected_launches(name)))
    layers = FLAGSHIP["num_layers"]
    fused = check_mesh_steps(
        "fused_ring", [r["fused_ring"] for r in ranks],
        single["fused"]["losses"],
        ring_launches(FUSED_EXTRA, SP, 1, layers, SP_SEQ))
    fused["peak_bytes_by_rank_unfused_ring"] = out["configs"]["ring"][
        "peak_bytes_by_rank"]
    out["fused_ring"] = dict(FUSED_EXTRA, **fused)
    out["dp_sp"] = check_dp_sp(ranks, single["causal"]["losses"])
    _model_def, bert_cfg, bert_batch = ENC_MODELS["bert"]
    out["bert_dp_sp"] = dict(check_mesh_steps(
        "bert_dp_sp", [r["bert_dp_sp"] for r in ranks],
        single["bert"]["losses"],
        ring_launches({"sp_impl": "ring"}, DP_SP_MESH["sp"],
                      DP_SP_MESH["dp"], bert_cfg["num_layers"],
                      bert_cfg["seq_len"], causal=False)),
        model=bert_cfg, minibatch=bert_batch, mesh=DP_SP_MESH,
        ring_rotation_check=bert_ring)
    small = []
    for r in ranks:
        gpu, cpu = r["small"]["cuda"], r["small"]["cpu"]
        errs = [abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])] + [
            abs(gpu["grad_norms"][k] - n) / max(n, 1e-30)
            for k, n in cpu["grad_norms"].items()]
        small.append(max(errs))
        check(max(errs) <= SP_SMALL_TOL_REL,
              "small fp32 ring step: card against CPU, rank %d rel err %.3g"
              % (r["rank"], max(errs)))
    out["small_ring_cuda_vs_cpu"] = {
        "model": SP_SMALL, "dtype": "fp32", "max_rel_err": max(small),
        "limit": SP_SMALL_TOL_REL, "loss_cuda": ranks[0]["small"]["cuda"][
            "loss"], "loss_cpu": ranks[0]["small"]["cpu"]["loss"]}
    # the windowed ring run's launches (SP_STEPS steps, summed over ranks)
    run = {k: n * SP_STEPS for k, n in sp_expected_launches(
        "ring_window").items()}
    return out, run


def check_offset_flash(gen):
    """Kernels A, C and D with pos_offset against their plain versions.
    Small shapes: fp32 and bf16, causal or not, windows none, 8, 24, 64,
    offsets 0, -l, l and l + 1 (every row of a causal rotation at -l
    sees no key; l is not a multiple of the 64-row tile, so the tile
    bounds are ragged), on every other case the segment ids of one
    packed row cut at both shards' positions (documents cross the shard
    boundary, as on a packed ring), GQA groups
    1, 2 and 4, l = 200, d 64 and 128; the backward of the bf16 cases
    writes fp32 gradients, as the ring asks. Then the ring path's shape
    (b 2, h 8, 1024-row shards, d 128, bf16, window 1536, fp32
    gradients) at SP_PATH_OFFSETS, the backward taking a ring-like
    global lse (the rotation's merged with the diagonal rotation's).
    Limits: those of the masked variants (fwd_ok for A, BWD_TOL_REL of
    the input dtype by masked_rel_err for C and D). Returns
    ({variant: worst errors}, the path shape's worst, its inputs)."""
    worst, path_worst = {}, {}
    i = 0
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for window in (None, 8, 24, 64):
                for offset in (0, -200, 200, 201):
                    h, hkv, d = MASKED_FLASH_SMALL[i % 4]
                    i += 1
                    q, k, v = flash_inputs(gen, 2, h, hkv, 200, d, dtype)
                    do = flash_inputs(gen, 2, h, h, 200, d, dtype)[0]
                    masks = {"window": window, "pos_offset": offset}
                    if i % 2:
                        # one packed row over both shards: the q rows'
                        # ids from positions 200 + offset on, the keys'
                        # from 200 on, so documents cross the boundary
                        seg = packed_segments(gen, 2, 601, docs=8).cuda()
                        masks.update(
                            q_seg=seg[:, 200 + offset:400 + offset],
                            k_seg=seg[:, 200:400])
                    grad = torch.float32 if dtype == torch.bfloat16 else None
                    errs, variant = _flash_case(q, k, v, do, causal, masks,
                                                grad_dtype=grad)
                    where = ("h=%d hkv=%d d=%d causal=%s window=%s offset=%d"
                             " %s" % (h, hkv, d, causal, window, offset,
                                      dtype))
                    _check_flash_errs(errs, variant, dtype, where)
                    for name, e in errs.items():
                        _worst(worst, name + variant, e)
    inputs = sp_rotation_inputs(gen)
    q, k, v, do, k2, v2 = inputs
    scale = q.shape[-1] ** -0.5
    _o, lse_diag = att.flash_forward(q, k2, v2, causal=True)
    for offset, causal in SP_PATH_OFFSETS:
        masks = {"window": SP_WINDOW, "pos_offset": offset}
        _o, lse_rot = att.attention_forward_lse(q, k, v, causal=causal,
                                                scale=scale, **masks)
        errs, variant = _flash_case(
            q, k, v, do, causal, masks, grad_dtype=torch.float32,
            lse_bwd=torch.logaddexp(lse_rot, lse_diag))
        _check_flash_errs(errs, variant, torch.bfloat16,
                          "the ring path's shape, offset %d" % offset)
        log("offset flash at the ring path's shape, offset %d: %s"
            % (offset, errs))
        for name, e in errs.items():
            _worst(path_worst, name + variant, e)
    log("offset flash kernels, worst at small shapes: %s" % worst)
    return worst, path_worst, inputs


def sp_rotation_inputs(gen):
    """One rank's q shard and the kv shard it holds, and a second kv
    shard (the diagonal rotation's), at the ring path's shape: b 2, h 8,
    1024 rows, d 128, bf16."""
    q, k, v = flash_inputs(gen, SP_BATCH, 8, 8, SP_LOCAL, 128,
                           torch.bfloat16)
    do = flash_inputs(gen, SP_BATCH, 8, 8, SP_LOCAL, 128, torch.bfloat16)[0]
    _q2, k2, v2 = flash_inputs(gen, SP_BATCH, 8, 8, SP_LOCAL, 128,
                               torch.bfloat16)
    return q, k, v, do, k2, v2


def check_ring_rotations(gen):
    """The windowed ring's rotation loop in one process: every rank's
    rotations at the sp path's shape (b 2, h 8, l SP_SEQ in SP shards of
    1024, d 128, bf16, causal, window SP_WINDOW) through the per-rotation
    functions the distributed ring calls (ring_rotation_forward /
    _backward, the kernels with their offsets) and lse_merge, against
    unsharded windowed attention on the card (kernels A, C, D at l
    SP_SEQ). Holds the kernels and the merge without any exchange.
    Limits: FLASH_TOL_OUT / FLASH_TOL_LSE, BWD_TOL_REL[bf16] by
    masked_rel_err."""
    b, h, d, n = SP_BATCH, 8, 128, SP_LOCAL
    q, k, v = flash_inputs(gen, b, h, h, SP_SEQ, d, torch.bfloat16)
    do = flash_inputs(gen, b, h, h, SP_SEQ, d, torch.bfloat16)[0]
    scale = d ** -0.5
    ref_out, ref_lse = att.flash_forward(q, k, v, causal=True,
                                         window=SP_WINDOW)
    ref = att.flash_backward(q, k, v, ref_out, ref_lse, do, causal=True,
                             window=SP_WINDOW)

    def shard(x, r):
        return x[:, :, r * n:(r + 1) * n].contiguous()

    outs, lses, rotations = [], [], 0
    for my in range(SP):
        o = torch.zeros((b, h, n, d), dtype=torch.float32, device="cuda")
        lse = torch.full((b, h, n), att.NEG_INF, device="cuda")
        for i in range(SP):
            src = (my + i) % SP
            part = cp.ring_rotation_forward(
                shard(q, my), shard(k, src), shard(v, src), None, None, src,
                my, SP, True, scale, SP_WINDOW)
            if part is not None:
                o, lse = att.lse_merge(o, lse, *part)
                rotations += 1
        outs.append(o.to(torch.bfloat16))
        lses.append(lse)
    out, lse = torch.cat(outs, 2), torch.cat(lses, 2)
    dq = [torch.zeros((b, h, n, d), device="cuda") for _ in range(SP)]
    dk = [torch.zeros((b, h, n, d), device="cuda") for _ in range(SP)]
    dv = [torch.zeros((b, h, n, d), device="cuda") for _ in range(SP)]
    for my in range(SP):
        for src in range(SP):
            grads = cp.ring_rotation_backward(
                shard(q, my), shard(k, src), shard(v, src), shard(out, my),
                shard(lse, my), shard(do, my), None, None, src, my, SP, True,
                scale, SP_WINDOW)
            if grads is not None:
                dq[my] += grads[0]
                dk[src] += grads[1]
                dv[src] += grads[2]
    torch.cuda.synchronize()
    errs = {"out_max_abs_err": (out.float() - ref_out.float()).abs().max()
            .item(),
            "lse_max_abs_err": (lse - ref_lse).abs().max().item()}
    for name, got, want in (("dq", dq, ref[0]), ("dk", dk, ref[1]),
                            ("dv", dv, ref[2])):
        errs[name + "_max_rel_err"] = masked_rel_err(torch.cat(got, 2),
                                                     want.float())
    log("ring rotation loop (%d rotations) against unsharded attention: %s"
        % (rotations, errs))
    check(rotations == 9, "the windowed ring ran %d rotations, not 9"
          % rotations)
    check(errs["out_max_abs_err"] <= FLASH_TOL_OUT
          and errs["lse_max_abs_err"] <= FLASH_TOL_LSE,
          "the ring's merged forward disagrees with unsharded attention: %s"
          % errs)
    check(max(errs[x + "_max_rel_err"] for x in ("dq", "dk", "dv"))
          <= BWD_TOL_REL[torch.bfloat16],
          "the ring's backward disagrees with unsharded attention: %s"
          % errs)
    return dict(errs, rotations=rotations, shape="b=%d h=%d l=%d in %d "
                "shards, d=%d, causal bf16, window %d"
                % (b, h, SP_SEQ, SP, d, SP_WINDOW))


def time_offset_flash(inputs, launches, errors):
    """Kernels A, C and D at the windowed ring's most frequent offset
    rotation (one shard back: q rows at positions 1024-2047 against keys
    0-1023, window 1536, the not-causal call the ring makes there; b 2,
    h 8, d 128, bf16; C and D with the ring's fp32 gradients and global
    lse), each against a bound over the pairs the mask keeps, its plain
    version, and SDPA with the same boolean mask. `launches`: {variant:
    launches in one windowed ring step summed over the ranks}."""
    q, k, v, do, k2, v2 = inputs
    b, h, l, d = q.shape
    offset = SP_LOCAL
    masks = {"window": SP_WINDOW, "pos_offset": offset}
    f32 = torch.float32
    _o, lse_diag = att.flash_forward(q, k2, v2, causal=True)
    out, lse = att.attention_forward_lse(q, k, v, **masks)
    lse_g = torch.logaddexp(lse, lse_diag)
    _dq, delta = att.flash_backward_dq(q, k, v, out, lse_g, do,
                                       grad_dtype=f32, **masks)
    mask = att._visible(l, l, False, SP_WINDOW, device=q.device,
                        pos_offset=offset)
    pairs = int(mask.sum().item()) * b
    lib_fwd, lib_bwd = sdpa_masked_ms(q, k, v, do, mask)
    rows = b * h * l
    io = 2 * d  # bf16 bytes of one row of d
    shape = ("b=%d h=%d lq=lk=%d d=%d bf16, window %d, pos_offset %d (one "
             "shard back, not causal), fp32 gradients" % (
                 b, h, l, d, SP_WINDOW, offset))
    entries = []
    for name, line, fn, plain, flops, nbytes, lib in (
            ("flash_fwd", 941,
             lambda: att.flash_forward(q, k, v, **masks),
             lambda: att.flash_attention_plain(q, k, v, bf16_operands=True,
                                               **masks),
             4 * d * pairs * h, io * 4 * rows + 4 * rows, lib_fwd),
            ("flash_bwd_dq", 1241,
             lambda: att.flash_backward_dq(q, k, v, out, lse_g, do,
                                           grad_dtype=f32, **masks),
             lambda: att.flash_backward_dq_plain(q, k, v, out, lse_g, do,
                                                 grad_dtype=f32, **masks),
             6 * d * pairs * h, io * 5 * rows + 4 * d * rows + 8 * rows,
             lib_bwd),
            ("flash_bwd_dkv", 1294,
             lambda: att.flash_backward_dkv(q, k, v, do, lse_g, delta,
                                            grad_dtype=f32, **masks),
             lambda: att.flash_backward_dkv_plain(q, k, v, do, lse_g, delta,
                                                  grad_dtype=f32, **masks),
             8 * d * pairs * h, io * 4 * rows + 8 * d * rows + 8 * rows,
             lib_bwd)):
        variant = name + "_window_offset"
        entry = _timing_entry(
            variant, "elasticdl_tpu_torch/csrc/%s.cu" % (
                "flash_fwd" if name == "flash_fwd" else "flash_bwd"),
            "elasticdl_tpu/ops/attention.py:%d (pos_offset: _block_run "
            ":840, _block_mask_apply :908)" % line,
            shape, fn, plain,
            (lib, "F.scaled_dot_product_attention with the same boolean "
             "mask, %s (eager)" % (
                 "forward" if name == "flash_fwd" else
                 "forward + backward less forward: dq, dk and dv")),
            (flops, nbytes), launches,
            dict(errors.get(variant, {}),
                 max_err=errors.get(variant, {}).get("max_abs_err")))
        entry["visible_pairs_per_head"] = pairs
        entry["launches_per_windowed_ring_step"] = (launches[variant]
                                                    // SP_STEPS)
        entries.append(entry)
    return entries


# ------------------------------------------------ checkpoint and recovery

# the job the phase trains, crashes, resumes and serves: CKPT_STEPS
# steps at CKPT_STEPS_PER_TASK a task, a checkpoint every CKPT_EVERY
# steps keeping CKPT_KEEP; run 1 dies by SIGKILL fetching its third task
CKPT_STEPS, CKPT_STEPS_PER_TASK = 6, 2
CKPT_EVERY, CKPT_KEEP = 2, 2
CKPT_FAULT = "local_get_task:kill:1:skip=2"
CKPT_KILLED_AT = 4  # the steps run 1 takes before it dies
CKPT_SERVE = ((37, 24), (200, 16), (513, 16), (64, 32))  # (prompt, new)


def _ckpt_job(workdir, cfg, batch, device, rng):
    """Write the phase's token records and its job file (read by the
    rank processes, `chip_smoke.py --ckpt-run RUN WORKDIR`)."""
    data = os.path.join(workdir, "train")
    os.makedirs(data)
    with RecordWriter(os.path.join(data, "tokens-00000.trec")) as w:
        for _ in range(batch * CKPT_STEPS):
            w.write(encode_example({"tokens": rng.randint(
                0, cfg["vocab_size"], size=(cfg["seq_len"] + 1,)).astype(
                    np.int64)}))
    job = {"data": data, "params": _params_str(cfg), "batch": batch,
           "device": device, "ckpt": os.path.join(workdir, "ckpt"),
           "job_state": os.path.join(workdir, "job_state")}
    with open(os.path.join(workdir, "job.json"), "w") as f:
        json.dump(job, f)
    return job


def _ckpt_executor(job, **extra):
    """The phase's LocalExecutor; the dispatcher's task shuffle seeded
    so every run sees the tasks in one order."""
    random.seed(0)
    return LocalExecutor(
        load_model_spec_from_module(tzoo), training_data=job["data"],
        minibatch_size=job["batch"],
        records_per_task=job["batch"] * CKPT_STEPS_PER_TASK,
        model_params=job["params"], device=job["device"], **extra)


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _record_steps(executor, device, out_path=None):
    """Wrap the executor's train step: each step's loss, host ms, wall
    clock at its start and end and kernel launches go to a list, and
    (flushed, so a killed process leaves them) one JSON line each to
    `out_path`. Returns the list."""
    steps = []
    step_fn = executor.trainer.train_step

    def recorded(state, batch, true_count=None):
        before = dict(att.KERNEL_LAUNCHES)
        _sync(device)
        t_start, t0 = time.time(), time.perf_counter()
        state, loss = step_fn(state, batch, true_count)
        _sync(device)
        rec = {"step": state.step, "loss": loss,
               "ms": (time.perf_counter() - t0) * 1e3,
               "t_start": t_start, "t_end": time.time(),
               "launches": {k: att.KERNEL_LAUNCHES[k] - before[k]
                            for k in att.KERNEL_LAUNCHES}}
        steps.append(rec)
        if out_path:
            with open(out_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return state, loss

    executor.trainer.train_step = recorded
    return steps


def ckpt_run_main(run, workdir):
    """Run 1 (killed by its fault rule) or run 2 (the resume) of the
    checkpoint phase, in a process of its own."""
    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    extra = dict(checkpoint_dir=job["ckpt"], checkpoint_steps=CKPT_EVERY,
                 keep_checkpoint_max=CKPT_KEEP,
                 job_state_dir=job["job_state"])
    if run == 2:
        extra["checkpoint_dir_for_init"] = job["ckpt"]
    executor = _ckpt_executor(job, **extra)
    _record_steps(executor, job["device"],
                  os.path.join(workdir, "run%d.steps.jsonl" % run))
    timing = {}
    init_state, ensure = executor.trainer.init_state, executor._ensure_state

    def timed_init(*args, **kwargs):
        t0 = time.perf_counter()
        out = init_state(*args, **kwargs)
        _sync(job["device"])
        timing["init_s"] = time.perf_counter() - t0
        return out

    def timed_ensure(batch):
        fresh = executor.state is None
        t0 = time.perf_counter()
        ensure(batch)
        _sync(job["device"])
        if fresh:
            timing["restore_s"] = (time.perf_counter() - t0
                                   - timing["init_s"])

    executor.trainer.init_state = timed_init
    executor._ensure_state = timed_ensure
    state, _ = executor.train()
    with open(os.path.join(workdir, "run%d.json" % run), "w") as f:
        json.dump(dict(timing, run=run, t_process_main=t_start,
                       final_step=state.step,
                       restored_version=executor.restored_version,
                       save=executor.checkpoint_saver.last_timing), f)


def _ckpt_spawn(run, target, fault, log_path):
    env = dict(os.environ)
    env.pop("EDL_FAULT_SPEC", None)
    if fault:
        env["EDL_FAULT_SPEC"] = fault
    repo = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    with open(log_path, "w") as log_f:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ckpt-run",
             str(run), target], stdout=log_f, stderr=subprocess.STDOUT,
            env=env)


def start_ckpt_run1():
    """Run 1 of the checkpoint phase, started early (beside the kernel
    checks): torch imported and its CUDA context made, it waits at its
    gate for the phase's working directory. Its steps' times come after
    the go. Returns the handle _ckpt_child takes."""
    tmp = tempfile.mkdtemp(prefix="ckpt_run1_")
    go, log_path = os.path.join(tmp, "go"), os.path.join(tmp, "run1.log")
    t_spawn = time.time()
    return {"proc": _ckpt_spawn(1, "gate:" + go, CKPT_FAULT, log_path),
            "go": go, "log": log_path, "dir": tmp, "t_spawn": t_spawn}


def close_ckpt_run1(handle):
    if handle["proc"].poll() is None:
        handle["proc"].kill()
        handle["proc"].wait()
    shutil.rmtree(handle["dir"], ignore_errors=True)


def _ckpt_child(run, workdir, fault="", early=None):
    """Run `run` in a process of its own (`early`: start_ckpt_run1's
    process, let go here); returns (rc, wall clock at the start, its
    step records, its summary or None)."""
    t_launch = time.time()
    if early is None:
        log_path = os.path.join(workdir, "run%d.log" % run)
        proc = _ckpt_spawn(run, workdir, fault, log_path)
    else:
        proc, log_path = early["proc"], early["log"]
        _gated_ready(early["go"], ["ckpt"], [proc], "checkpoint run 1")
        _go(early["go"], workdir)
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    steps_path = os.path.join(workdir, "run%d.steps.jsonl" % run)
    steps = []
    if os.path.exists(steps_path):
        with open(steps_path) as f:
            steps = [json.loads(line) for line in f if line.strip()]
    summary_path = os.path.join(workdir, "run%d.json" % run)
    summary = None
    if os.path.exists(summary_path):
        with open(summary_path) as f:
            summary = json.load(f)
    with open(log_path) as f:
        tail = f.read()[-3000:]
    log("checkpoint run %d: rc %d, %d steps; log tail:\n%s"
        % (run, rc, len(steps), tail))
    return rc, t_launch, steps, summary


def _flat_diff(a, b):
    """(largest |a - b| over every leaf, the leaves that differ)."""
    check(sorted(a) == sorted(b), "the resumed and the uninterrupted state "
          "name other leaves")
    worst, differ = 0.0, []
    for name in a:
        x = np.asarray(a[name], np.float64)
        y = np.asarray(b[name], np.float64)
        if x.shape != y.shape:
            differ.append(name)
            worst = math.inf
            continue
        d = float(np.max(np.abs(x - y))) if x.size else 0.0
        if d or not np.array_equal(np.asarray(a[name]), np.asarray(b[name])):
            differ.append(name)
            worst = max(worst, d)
    return worst, differ


def _ckpt_serve(args_or_model, lines, device):
    """Serve `lines` through a server built by serving/main.py from
    argv, or around a model; returns (answers, launches, version)."""
    att.reset_launch_counts()
    if isinstance(args_or_model, list):
        server = serving_main.build_server(
            serving_main.parse_serving_args(args_or_model))
    else:
        server = GenerationServer(args_or_model, ServingConfig(
            num_slots=8, kv_paged=True, kv_block_size=16))
    server.start()
    try:
        answers = serving_main.serve_lines(server, lines)
    finally:
        server.stop(drain=True)
    _sync(device)
    return answers, dict(att.KERNEL_LAUNCHES), server.model_version


def checkpoint_phase(rng, workdir, cfg=FLAGSHIP, batch=TRAIN_BATCH,
                     device="cuda", early=None):
    """Train -> crash -> resume -> serve at `cfg`: run 1 (a process)
    dies by SIGKILL at the dispatch boundary after CKPT_KILLED_AT steps,
    run 2 (a process) resumes from its checkpoint and job state and
    trains the last task, run 3 (here) trains all CKPT_STEPS without a
    stop. Run 2's losses, parameters and AdamW slots must equal run 3's,
    and a server built from run 2's checkpoint through serving/main.py
    must give the greedy tokens of a server over run 3's parameters.
    Then one save's time, synchronous and async. Returns (metrics,
    launches by part, the job: its records feed phase 24)."""
    on_card = device == "cuda"
    layers = cfg["num_layers"]
    job = _ckpt_job(workdir, cfg, batch, device, rng)
    ckpt = job["ckpt"]
    if on_card:
        torch.cuda.empty_cache()
    # run 1: the crash
    rc1, _, steps1, _ = _ckpt_child(1, workdir, fault=CKPT_FAULT,
                                    early=early)
    check(rc1 == -9, "run 1 ended with rc %d, not by SIGKILL (-9)" % rc1)
    check([s["step"] for s in steps1] == list(range(1, CKPT_KILLED_AT + 1)),
          "run 1 took steps %s before it died" % [s["step"] for s in steps1])
    versions = sorted(os.listdir(ckpt))
    check(versions == ["version-2", "version-4"],
          "run 1 left %s, not version-2 and version-4" % versions)
    t0 = time.perf_counter()
    manifest = verify_checkpoint(ckpt, CKPT_KILLED_AT)
    verify_s = time.perf_counter() - t0
    # run 2: the resume
    rc2, t_launch2, steps2, run2 = _ckpt_child(2, workdir)
    check(rc2 == 0 and run2 is not None, "run 2 ended with rc %d" % rc2)
    check(run2["restored_version"] == CKPT_KILLED_AT
          and run2["final_step"] == CKPT_STEPS
          and [s["step"] for s in steps2] == list(
              range(CKPT_KILLED_AT + 1, CKPT_STEPS + 1)),
          "run 2 restored version %s and took steps %s" % (
              run2["restored_version"], [s["step"] for s in steps2]))
    check(get_latest_checkpoint_version(ckpt) == CKPT_STEPS,
          "run 2 did not save version %d" % CKPT_STEPS)
    def control():
        """Run 3, the uninterrupted run, in this process."""
        executor = _ckpt_executor(job)
        steps = _record_steps(executor, device)
        att.reset_launch_counts()
        state, _ = executor.train()
        del executor.trainer.train_step
        check(state.step == CKPT_STEPS, "the control took %d steps"
              % state.step)
        return executor, steps

    ex3, steps3 = control()
    if on_card:
        for s in steps1 + steps2 + steps3:
            for name in TRAINING_KERNELS:
                check(s["launches"][name] == layers,
                      "checkpoint phase step %d launched %s %d times, not %d"
                      % (s["step"], name, s["launches"][name], layers))
    resumed_losses = [s["loss"] for s in steps1 + steps2]
    control_losses = [s["loss"] for s in steps3]
    flat3 = flatten_state(ex3.trainer, ex3.state)
    flat6, _ = load_checkpoint(ckpt, CKPT_STEPS)
    resumed_diff, differ = _flat_diff(flat6, flat3)
    loss_diff = max(abs(a - b) for a, b in zip(resumed_losses,
                                                control_losses))
    log("checkpoint phase losses: resumed %s, uninterrupted %s; largest "
        "state difference %r over %d leaves"
        % (resumed_losses, control_losses, resumed_diff, len(differ)))
    bitwise = not differ and resumed_losses == control_losses
    control_diff = None
    if not bitwise:
        # a kernel on the path is not deterministic: the bound is what
        # two uninterrupted runs show between themselves
        ex4, steps4 = control()
        control_diff, _ = _flat_diff(flatten_state(ex4.trainer, ex4.state),
                                     flat3)
        control_loss_diff = max(abs(s["loss"] - t["loss"])
                                for s, t in zip(steps4, steps3))
        log("two uninterrupted runs differ by %r (state), %r (loss)"
            % (control_diff, control_loss_diff))
        check(resumed_diff <= control_diff
              and loss_diff <= control_loss_diff,
              "resumed vs uninterrupted %r / %r exceeds two uninterrupted "
              "runs' %r / %r" % (resumed_diff, loss_diff, control_diff,
                                 control_loss_diff))
        del ex4
    # serving: from the checkpoint through serving/main.py, and over the
    # control's parameters
    prompts = [(rng.randint(0, cfg["vocab_size"],
                            size=min(n, cfg["seq_len"] // 2)).tolist(), new)
               for n, new in CKPT_SERVE]
    lines = [json.dumps({"prompt": p, "max_new_tokens": new})
             for p, new in prompts]
    argv = ["--device", device, "--model_params", job["params"],
            "--checkpoint_dir", ckpt, "--num_slots", "8",
            "--kv_paged", "1", "--kv_block_size", "16"]
    t0 = time.perf_counter()
    served, serve_launches, version = _ckpt_serve(argv, lines, device)
    serve_s = time.perf_counter() - t0
    model3 = tzoo.custom_model(device=device,
                               **get_dict_from_params_str(job["params"]))
    model3.load_state_dict(ex3.trainer.model.state_dict())
    reference, _, _ = _ckpt_serve(model3, lines, device)
    del model3
    check(version == CKPT_STEPS, "the server serves version %d" % version)
    check(all("tokens" in a and len(a["tokens"]) == len(p) + new
              for a, (p, new) in zip(served, prompts)),
          "serving from the checkpoint: %s" % served)
    check(served == reference, "serving from the checkpoint gave other "
          "tokens than the uninterrupted run's parameters")
    if on_card:
        for name in ("flash_fwd", "paged_decode"):
            check(serve_launches[name] > 0, "serving from the checkpoint "
                  "launched no %s" % name)
    # one save's time, synchronous and async, and a restore, on the
    # control's state
    shutil.rmtree(ckpt)
    times_dir = os.path.join(workdir, "timing")
    trainer3, state3 = ex3.trainer, ex3.state
    saver = CheckpointSaver(trainer3, times_dir, keep_max_version=1)
    t0 = time.perf_counter()
    saver.save(state3, CKPT_STEPS)
    sync_s = time.perf_counter() - t0
    sync = dict(saver.last_timing, total_s=sync_s,
                gb_per_s=saver.last_timing["bytes"] / sync_s / 1e9)
    tokens = rng.randint(0, cfg["vocab_size"],
                         size=(batch, cfg["seq_len"] + 1)).astype(np.int32)
    fixed = ({"tokens": tokens[:, :-1]}, tokens[:, 1:])

    def step_ms():
        _sync(device)
        t0 = time.perf_counter()
        trainer3.train_step(state3, fixed)
        _sync(device)
        return (time.perf_counter() - t0) * 1e3

    quiet = [step_ms() for _ in range(2)]
    asaver = CheckpointSaver(trainer3, times_dir, keep_max_version=1,
                             async_save=True)
    saved_step = state3.step
    t0 = time.perf_counter()
    asaver.save(state3, saved_step)
    paid_ms = (time.perf_counter() - t0) * 1e3
    during = [step_ms() for _ in range(2)]
    asaver.wait()
    async_total = time.perf_counter() - t0
    t0 = time.perf_counter()
    restore_state_from_checkpoint(trainer3, state3, times_dir)
    _sync(device)
    restore_here_s = time.perf_counter() - t0
    check(state3.step == saved_step, "the timing restore read step %d, not "
          "%d" % (state3.step, saved_step))
    shutil.rmtree(times_dir)
    recover_s = steps2[0]["t_end"] - t_launch2
    metrics = {
        "model": "transformer_lm %s, bf16 compute, fp32 params, AdamW"
                 % ("flagship" if cfg is FLAGSHIP else "small"),
        "minibatch": batch, "seq_len": cfg["seq_len"],
        "steps": CKPT_STEPS, "steps_per_task": CKPT_STEPS_PER_TASK,
        "checkpoint_steps": CKPT_EVERY, "keep_checkpoint_max": CKPT_KEEP,
        "fault": CKPT_FAULT,
        "run1": {"rc": rc1, "steps": len(steps1),
                 "versions_on_disk": versions,
                 "step_ms": [s["ms"] for s in steps1]},
        "run2": {"rc": rc2, "restored_version": run2["restored_version"],
                 "final_step": run2["final_step"],
                 "process_main_after_launch_s":
                     run2["t_process_main"] - t_launch2,
                 "init_s": run2["init_s"], "restore_s": run2["restore_s"],
                 "first_step_start_after_launch_s":
                     steps2[0]["t_start"] - t_launch2,
                 "save": run2["save"],
                 "step_ms": [s["ms"] for s in steps2]},
        "time_to_recover_s": recover_s,
        "time_to_recover_is": "from run 2's process start to the end of "
                              "its first step",
        "losses_resumed": resumed_losses, "losses_uninterrupted":
            control_losses,
        "bitwise_equal": bitwise,
        "resumed_vs_uninterrupted_max_abs": resumed_diff,
        "resumed_vs_uninterrupted_loss_max_abs": loss_diff,
        "leaves_differing": differ[:10],
        "two_uninterrupted_runs_max_abs": control_diff,
        "checkpoint_bytes": manifest["bytes"],
        "leaf_count": manifest["leaf_count"],
        "verify_s": verify_s,
        "save_sync": sync,
        "save_async": {"paid_ms": paid_ms, "total_s": async_total,
                       "step_ms_without_write": quiet,
                       "step_ms_during_write": during},
        "restore_s_in_process": restore_here_s,
        "serving": {"requests": len(prompts),
                    "new_tokens": sum(n for _p, n in prompts),
                    "model_version": version, "wall_s": serve_s,
                    "tokens_equal_uninterrupted": served == reference},
        "launches_per_step": {k: steps3[-1]["launches"][k]
                              for k in TRAINING_KERNELS},
    }
    launches = {"training_per_step": metrics["launches_per_step"],
                "serving": {k: serve_launches[k] for k in SERVING_KERNELS}}
    del ex3, trainer3, state3
    return metrics, launches, job


# ------------------------------------------------ the elastic job (phase 24)

MW_EPOCHS = 2  # the drill's epochs over phase 22's records
MW_WORKERS = 2  # the drill's worker processes; they share the card
MW_DEADLINE_S = 300  # every wait of the phase
MW_POLL_S = 0.02


def _mw_wait(cond, what, deadline_s=MW_DEADLINE_S):
    deadline = time.monotonic() + deadline_s
    while not cond():
        check(time.monotonic() < deadline,
              "master_worker: timed out waiting for %s" % what)
        time.sleep(MW_POLL_S)


def _mw_run_bounded(fn, what, deadline_s=MW_DEADLINE_S):
    """fn() on a thread joined with a deadline; its exception re-raised
    here."""
    errors = []

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(timeout=deadline_s)
    check(not thread.is_alive(), "master_worker: %s did not finish in %d s"
          % (what, deadline_s))
    if errors:
        raise errors[0]


def _mw_common_args(job, device):
    """The flags of a job over phase 22's records, as the CLI takes
    them and the master hands them to its workers."""
    repo = os.path.dirname(os.path.abspath(__file__))
    return ["--model_zoo", os.path.join(repo, "elasticdl_tpu_torch",
                                        "model_zoo"),
            "--model_def", "transformer_lm.custom_model",
            "--model_params", job["params"],
            "--training_data", job["data"],
            "--minibatch_size", str(job["batch"]),
            "--records_per_task", str(job["batch"] * CKPT_STEPS_PER_TASK),
            "--seed", "0", "--device", device]


def _mw_env():
    env = dict(os.environ)
    env.pop("EDL_FAULT_SPEC", None)
    repo = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    return env


def _mw_master(job, **kwargs):
    """A Master over the job's records, the task shuffle seeded as the
    CLI's master seeds it (--seed 0); `stamps` records each worker's
    first register_worker and get_task, `dispatched` the (worker, shard,
    start, end) of the tasks given out, in order. Handlers are wrapped
    before prepare() binds them."""
    random.seed(0)
    master = Master(load_model_spec_from_module(tzoo),
                    training_data=job["data"], minibatch_size=job["batch"],
                    records_per_task=job["batch"] * CKPT_STEPS_PER_TASK,
                    **kwargs)
    master.stamps = {"register_worker": {}, "get_task": {}}
    master.dispatched = []
    master.dispatched_ids = {}  # task id -> (worker, shard, start)
    for name, seen in master.stamps.items():
        fn = getattr(master.servicer, name)

        def stamped(request, _context=None, fn=fn, seen=seen):
            seen.setdefault(request.worker_id, time.time())
            return fn(request, _context)

        setattr(master.servicer, name, stamped)
    get = master.task_d.get

    def recorded(worker_id):
        task_id, task = get(worker_id)
        if task is not None:
            master.dispatched.append((worker_id, task.shard_name,
                                      task.start, task.end))
            master.dispatched_ids[task_id] = (worker_id, task.shard_name,
                                              task.start)
        return task_id, task

    master.task_d.get = recorded
    return master


def _mw_stream_reference(job, dispatched, device):
    """(losses, flat state) of a Trainer fed what a worker's stream over
    `dispatched` gives: the tasks' records in dispatch order through
    the zoo's dataset_fn (its shuffle buffer holds the whole stream),
    batched and padded as the worker does, with its seed."""
    records = [r for _worker, shard, start, end in dispatched
               for r in Scanner(shard, start, end - start)]
    spec = load_model_spec_from_module(tzoo)
    ds = spec.dataset_fn(Dataset.from_list(records), Mode.TRAINING, None)
    trainer = Trainer(spec, model_params=job["params"], device=device)
    state, losses, step_ms = None, [], []
    for batch in ds.batch(job["batch"]):
        padded, n = pad_batch(batch, job["batch"])
        if state is None:
            state = trainer.init_state(padded)
        _sync(device)
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, padded, n)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    flat = flatten_state(trainer, state)
    del trainer, state
    return losses, flat, step_ms


def _pcts(secs):
    ms = np.sort(np.asarray(list(secs), np.float64)) * 1e3
    if not ms.size:
        return None
    return {"calls": int(ms.size), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(ms[-1])}


def _log_tail(path, n=3000):
    if not os.path.exists(path):
        return "(no log)"
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def _worker_timeline(path):
    """The timeline a worker process logs at its exit (worker/main.py),
    or None."""
    if not os.path.exists(path):
        return None
    with open(path, errors="replace") as f:
        for line in f:
            if " timeline " in line:
                return json.loads(line.split(" timeline ", 1)[1])
    return None


def _start_cuda_init_probe():
    """A throwaway process that prints the seconds a fresh process takes
    to import torch and to create its CUDA context."""
    code = ("import time; t0 = time.time(); import torch; t1 = time.time(); "
            "torch.zeros(1, device='cuda'); torch.cuda.synchronize(); "
            "print(t1 - t0, time.time() - t1)")
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)


def _read_cuda_init_probe(proc):
    try:
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, "the CUDA start-up probe failed")
    import_s, init_s = map(float, out.split())
    return {"import_torch_s": import_s, "cuda_context_s": init_s}


def _child_pid(ppid, marker):
    """The pid of a child of `ppid` whose command line holds `marker`
    (bytes), or None."""
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % name) as f:
                parent = int(f.read().rsplit(")", 1)[1].split()[1])
            if parent != ppid:
                continue
            with open("/proc/%s/cmdline" % name, "rb") as f:
                if marker in f.read():
                    return int(name)
        except (OSError, ValueError, IndexError):
            continue
    return None


def _mw_sigusr2(proc, cli_log):
    """Phase 35 (iii) on the CLI job: SIGUSR2 to its master (the CLI
    process) and, once its worker has logged its start (the handler is
    installed before that line), to the worker; each must dump its
    stacks and run on (the job's rc and checkpoint are checked after)."""
    deadline = time.monotonic() + MW_DEADLINE_S
    worker = None
    while worker is None:
        check(proc.poll() is None and time.monotonic() < deadline,
              "the CLI job ended before its worker started")
        with open(cli_log, errors="replace") as f:
            if "[worker] Worker 0 starting" in f.read():
                worker = _child_pid(proc.pid,
                                    b"elasticdl_tpu_torch.worker.main")
        if worker is None:
            time.sleep(0.05)

    def running(pid):
        with open("/proc/%d/stat" % pid) as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in "ZX"

    _sigusr2("master", proc.pid, lambda: check(
        proc.poll() is None, "the master died after SIGUSR2"))
    _sigusr2("worker", worker, lambda: check(
        running(worker), "the worker died after SIGUSR2"))


def _span_exports(trace_dir, service):
    """The span dicts of every `spans-<service>-<pid>.json` export."""
    spans = []
    for path in glob.glob(os.path.join(trace_dir, "spans-%s-*.json"
                                       % service)):
        with open(path) as f:
            spans += json.load(f)["spans"]
    return spans


def _task_children(dispatch, worker_spans, where):
    """The one worker_task span under each dispatch span, its task id
    the dispatch's."""
    for d in dispatch:
        kids = [w for w in worker_spans if w["name"] == "worker_task"
                and w["parent_span_id"] == d["span_id"]]
        check(len(kids) == 1 and kids[0]["trace_id"] == d["trace_id"]
              and kids[0]["attrs"]["task_id"] == d["attrs"]["task_id"]
              and kids[0]["status"] == "ok", "%s: task %s has the worker "
              "spans %s" % (where, d["attrs"]["task_id"], kids))


def _mw_cli_traces(trace_dir, tb_dir):
    """Phase 24 (2)'s exports: the master's and worker 0's span files,
    every task_dispatch span sealed ok with one worker_task child; the
    master's event file (its recovery gauges) read clean."""
    master_spans = _span_exports(trace_dir, "master-*")
    worker_spans = _span_exports(trace_dir, "worker-0")
    dispatch = [s for s in master_spans if s["name"] == "task_dispatch"]
    tasks = CKPT_STEPS // CKPT_STEPS_PER_TASK
    check(len(dispatch) == tasks and all(
        d["status"] == "ok" for d in dispatch), "master_worker (2): the "
        "master exported %s, not %d task_dispatch spans sealed ok"
        % ([(d["name"], d["status"]) for d in master_spans], tasks))
    _task_children(dispatch, worker_spans, "master_worker (2)")
    scalars = read_event_file(_event_file(tb_dir))
    # the recovery gauges, and the worker's fault/ gauges if a call of
    # its was retried
    recovery = sorted(x for x in scalars if x[1].startswith("master/"))
    check(recovery == [(0, "master/recovery_requeued_tasks", 0.0),
                       (0, "master/restarts", 0.0)] and all(
              t.startswith(("master/", "fault/")) and (
                  t.startswith("master/") or t.endswith("/worker-0"))
              for _s, t, _v in scalars),
          "master_worker (2): the master's event file holds %s" % scalars)
    return {"task_dispatch": len(dispatch),
            "worker_task": sum(s["name"] == "worker_task"
                               for s in worker_spans),
            "event_scalars": len(scalars)}


def _mw_drill_traces(master, t0, trace_dir, victim, held):
    """Phase 24 (3)'s traces. The killed worker's dispatch spans stay open
    in the servicer: its tasks were requeued by the dispatcher under new
    task ids, so no report and no re-dispatch of the same id seals them
    (the JAX servicer alike). Each held range has that open span and a
    later one sealed ok on another worker; every span sealed ok whose
    worker exited cleanly has one worker_task child in that worker's
    export; the killed worker exported none (SIGKILL skips atexit)."""
    sealed = [s.to_dict() for s in recorder().snapshot()
              if s.name == "task_dispatch" and s.start >= t0]
    open_spans = getattr(master.servicer, "_task_spans", {})
    ids = master.dispatched_ids
    victim_open = {ids[tid][1:] for tid, span in open_spans.items()
                   if span.attrs["worker_id"] == victim}
    ok = [s for s in sealed if s["status"] == "ok"]
    later = {ids[s["attrs"]["task_id"]][1:] for s in ok
             if s["attrs"]["worker_id"] != victim}
    check(held <= victim_open and held <= later, "master_worker (3): the "
          "killed worker held %s; open spans %s, sealed ok elsewhere %s"
          % (sorted(held), sorted(victim_open), sorted(later)))
    check(all(s["status"] == "ok" for s in sealed), "master_worker (3): "
          "dispatch spans sealed %s" % sorted({s["status"] for s in sealed}))
    check(not glob.glob(os.path.join(trace_dir, "spans-worker-%d-*.json"
                                     % victim)),
          "master_worker (3): the killed worker exported spans")
    survivors = [s for s in ok if s["attrs"]["worker_id"] != victim]
    worker_spans = _span_exports(trace_dir, "worker-*")
    _task_children(survivors, worker_spans, "master_worker (3)")
    return {"sealed_ok": len(ok), "open": len(open_spans),
            "killed_open": len(victim_open), "worker_task": len(
                worker_spans), "requeued_ranges": len(held)}


def master_worker_phase(job, workdir, device="cuda"):
    """The elastic job at the flagship over phase 22's records (see the
    module docstring, 24). Returns (metrics, part 1's launches)."""
    on_card = device == "cuda"
    layers = get_dict_from_params_str(job["params"])["num_layers"]
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
    # (1) a Master over the transport and one Worker here
    master = _mw_master(job)
    master.prepare()
    worker = None
    try:
        worker = Worker(0, load_model_spec_from_module(tzoo),
                        master_addr="localhost:%d" % master.port,
                        minibatch_size=job["batch"],
                        training_data=job["data"],
                        model_params=job["params"], wait_sleep_secs=0.05,
                        device=device)
        steps = _record_steps(worker, device)
        att.reset_launch_counts()
        t0 = time.perf_counter()
        _mw_run_bounded(worker.run, "the in-process worker")
        _sync(device)
        part1_s = time.perf_counter() - t0
        launches = {k: att.KERNEL_LAUNCHES[k] for k in TRAINING_KERNELS}
        check(master.task_d.finished() and worker.job_complete,
              "master_worker (1): the job did not complete")
    finally:
        master.stop()
        if worker is not None:
            worker.close()
    check(worker.state.step == CKPT_STEPS and len(steps) == CKPT_STEPS,
          "master_worker (1): %d steps, not %d" % (len(steps), CKPT_STEPS))
    if on_card:
        for s in steps:
            for name in TRAINING_KERNELS:
                check(s["launches"][name] == layers,
                      "master_worker (1) step %d launched %s %d times, "
                      "not %d" % (s["step"], name, s["launches"][name],
                                  layers))
        for name in TRAINING_KERNELS:
            check(launches[name] == layers * CKPT_STEPS,
                  "master_worker (1) launched %s %d times, not %d"
                  % (name, launches[name], layers * CKPT_STEPS))
    flat1 = flatten_state(worker.trainer, worker.state)
    losses1 = list(worker.losses)
    rpc = {name: _pcts(secs) for name, secs in worker.rpc_seconds.items()}
    rpc_all = _pcts(itertools.chain.from_iterable(
        secs for name, secs in worker.rpc_seconds.items()
        if name == "get_task" or name.startswith("report_")))
    timeline1 = dict(worker.timeline)
    dispatched = list(master.dispatched)
    del worker
    if on_card:
        torch.cuda.empty_cache()
    ref_losses, ref_flat, ref_step_ms = _mw_stream_reference(
        job, dispatched, device)
    ref_diff, ref_differ = _flat_diff(flat1, ref_flat)
    del ref_flat
    log("master_worker (1): losses %s, the stream reference's %s; state "
        "difference %r over %d leaves" % (losses1, ref_losses, ref_diff,
                                           len(ref_differ)))
    check(losses1 == ref_losses and not ref_differ,
          "master_worker (1): the worker's losses or state differ from a "
          "Trainer fed its stream's batches (%d leaves differ, largest "
          "%r)" % (len(ref_differ), ref_diff))
    if on_card:
        torch.cuda.empty_cache()
    # (2) the CLI, a process: its master here-in-that-process, one worker
    cli_dir = os.path.join(workdir, "cli")
    os.makedirs(cli_dir)
    status = os.path.join(cli_dir, "status.json")
    ckpt = os.path.join(cli_dir, "ckpt")
    cli_traces = os.path.join(cli_dir, "traces")
    cli_tb = os.path.join(cli_dir, "tb")
    cmd = ([sys.executable, "-m", "elasticdl_tpu_torch.client.main",
            "train"] + _mw_common_args(job, device)
           + ["--num_workers", "1", "--port", "0", "--checkpoint_dir", ckpt,
              "--checkpoint_steps", str(CKPT_STEPS), "--job_status_file",
              status, "--need_tensorboard", "--tensorboard_log_dir",
              cli_tb, "--job_state_dir", os.path.join(cli_dir, "state")])
    cli_log = os.path.join(cli_dir, "cli.log")
    # the start-up probe runs beside the CLI's own start-up
    probe = _start_cuda_init_probe() if on_card else None
    t0 = time.perf_counter()
    with open(cli_log, "w") as log_f:
        # a session of its own: a failure here kills its worker with it
        proc = subprocess.Popen(cmd, stdout=log_f, stderr=subprocess.STDOUT,
                                env=dict(_mw_env(),
                                         EDL_TRACE_DIR=cli_traces),
                                cwd=cli_dir, start_new_session=True)
        try:
            if on_card:
                _mw_sigusr2(proc, cli_log)
            rc = proc.wait(timeout=MW_DEADLINE_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    cli_s = time.perf_counter() - t0
    fresh_process = _read_cuda_init_probe(probe) if probe else None
    cli_status = job_status.read_job_status(status) or {}
    if rc != 0 or cli_status.get("status") != job_status.SUCCEEDED:
        log("master_worker (2): the CLI's log tail:\n%s" % _log_tail(cli_log))
    check(rc == 0 and cli_status.get("status") == job_status.SUCCEEDED,
          "master_worker (2): the CLI ended with rc %d, status %s"
          % (rc, cli_status.get("status")))
    check(get_latest_checkpoint_version(ckpt) == CKPT_STEPS,
          "master_worker (2): the CLI's job saved no version %d"
          % CKPT_STEPS)
    flat2, _ = load_checkpoint(ckpt, CKPT_STEPS)
    cli_diff, cli_differ = _flat_diff(flat2, flat1)
    del flat2
    check(not cli_differ, "master_worker (2): the CLI's checkpoint differs "
          "from (1)'s state in %d leaves (largest %r)"
          % (len(cli_differ), cli_diff))
    cli_traced = _mw_cli_traces(cli_traces, cli_tb)
    del flat1
    if on_card:
        torch.cuda.empty_cache()
    # (3) the elastic drill: two worker processes, one killed
    drill_dir = os.path.join(workdir, "drill")
    logs = os.path.join(drill_dir, "logs")
    state_dir = os.path.join(drill_dir, "job_state")
    drill_traces = os.path.join(drill_dir, "traces")
    master = _mw_master(job, num_epochs=MW_EPOCHS, job_state_dir=state_dir)
    master.prepare()
    manager = LocalInstanceManager(
        master.task_d, num_workers=MW_WORKERS,
        worker_args=_mw_common_args(job, device) + [
            "--master_addr", "localhost:%d" % master.port,
            "--job_type", "training_only"],
        env=dict(_mw_env(), EDL_TRACE_DIR=drill_traces), log_dir=logs)
    t_drill = time.time()
    master.instance_manager = manager
    t0 = time.perf_counter()
    new_id = MW_WORKERS
    try:
        manager.start_workers()
        _mw_wait(lambda: master.task_d.doing_tasks(), "a task in flight")
        holders = {w for w, _t, _s in master.task_d.doing_tasks().values()}
        victim = min(holders)
        held = {(t.shard_name, t.start) for w, t, _s in
                master.task_d.doing_tasks().values() if w == victim}
        t_kill = time.time()
        manager.remove_worker(victim)
        _mw_wait(lambda: manager.worker_phase(new_id) is not None,
                 "the relaunch")
        check(manager.worker_phase(victim) in ("Failed", "Deleted"),
              "master_worker (3): the killed worker is %s"
              % manager.worker_phase(victim))
        failed_seen = []

        def done():
            failed_seen.append(manager.all_workers_failed())
            return master.task_d.finished()

        _mw_wait(done, "the drill's job to finish")
        _mw_wait(lambda: new_id in master.stamps["get_task"],
                 "the new worker's first get_task")
        check(manager.wait_all(MW_DEADLINE_S),
              "master_worker (3): worker processes still run after "
              "JOB_COMPLETE")
    except SmokeFailure:
        for wid in manager.workers():
            log("worker %d log tail:\n%s" % (wid, _log_tail(os.path.join(
                logs, "worker-%d.log" % wid))))
        raise
    finally:
        master.stop()
    drill_s = time.perf_counter() - t0
    check(not any(failed_seen), "master_worker (3): all_workers_failed "
          "became true")
    workers = manager.workers()
    check(workers[victim][4] == 137 and workers[new_id][0]
          == workers[victim][0] and workers[new_id][2] == 0,
          "master_worker (3): the kill and relaunch left %s" % workers)
    check(all(w[4] == 0 for wid, w in workers.items() if wid != victim),
          "master_worker (3): a worker exited badly: %s" % workers)
    _, events = JobStateStore(state_dir).load()
    done_ranges = sorted(tuple(e["task"][:3]) for e in events
                         if e["ev"] in ("done", "done_recovered"))
    failed = {(e["task"][0], e["task"][1]) for e in events
              if e["ev"] == "fail"}
    victim_tasks = {(shard, start) for w, shard, start, _end in
                    master.dispatched if w == victim}
    per_task = job["batch"] * CKPT_STEPS_PER_TASK
    per_epoch = [(shard, s, min(s + per_task, start + n))
                 for shard, (start, n) in RecordIODataReader(
                     job["data"]).create_shards().items()
                 for s in range(start, start + n, per_task)]
    check(done_ranges == sorted(per_epoch * MW_EPOCHS),
          "master_worker (3): ranges done %s, not each range once an "
          "epoch" % done_ranges)
    check(held <= failed <= victim_tasks,
          "master_worker (3): requeued %s; the killed worker held %s and "
          "was given %s" % (sorted(failed), sorted(held),
                            sorted(victim_tasks)))
    drill_traced = _mw_drill_traces(master, t_drill, drill_traces, victim,
                                    held)
    timelines = {wid: _worker_timeline(os.path.join(
        logs, "worker-%d.log" % wid)) for wid in workers}
    startup = {}
    for wid, (slot, phase, relaunches, launched, code) in workers.items():
        tl = timelines.get(wid) or {}
        entry = {"slot": slot, "phase": phase, "exit_code": code,
                 "relaunches_used": relaunches}
        for key in ("main", "built", "registered", "first_get_task",
                    "state_ready", "first_step"):
            if key in tl:
                entry[key + "_after_launch_s"] = tl[key] - launched
        if wid in master.stamps["register_worker"]:
            entry["master_saw_register_after_launch_s"] = (
                master.stamps["register_worker"][wid] - launched)
        startup[wid] = entry
    metrics = {
        "model": "transformer_lm %s, AdamW" % job["params"],
        "minibatch": job["batch"], "steps": CKPT_STEPS,
        "steps_per_task": CKPT_STEPS_PER_TASK,
        "in_process": {
            "wall_s": part1_s, "losses": losses1,
            "equal_stream_reference_bitwise": True,
            "stream_reference_losses": ref_losses,
            "step_ms": [s["ms"] for s in steps],
            "stream_reference_step_ms": ref_step_ms,
            "rpc_round_trip": rpc_all, "rpc_by_method": rpc,
            "launches": launches,
            "launches_per_step": {k: steps[-1]["launches"][k]
                                  for k in TRAINING_KERNELS},
            "timeline_s": {k: v - timeline1["built"]
                           for k, v in timeline1.items()},
            "tasks_dispatched": len(dispatched)},
        "cli": {"rc": rc, "status": cli_status.get("status"),
                "wall_s": cli_s, "checkpoint_version": CKPT_STEPS,
                "checkpoint_equal_in_process_bitwise": True},
        "drill": {"workers": MW_WORKERS, "epochs": MW_EPOCHS,
                  "wall_s": drill_s, "killed": victim,
                  "killed_held_tasks": len(held), "relaunched_as": new_id,
                  "kill_to_new_worker_first_get_task_s":
                      master.stamps["get_task"][new_id] - t_kill,
                  "new_worker_launch_after_kill_s":
                      workers[new_id][3] - t_kill,
                  "ranges_done": len(done_ranges),
                  "requeued": sum(e["ev"] == "fail" for e in events),
                  "workers": {str(k): v for k, v in startup.items()}},
        "fresh_process": fresh_process,
        "traces": {"cli": cli_traced, "drill": drill_traced},
        "phase_wall_s": time.perf_counter() - t_phase,
    }
    log("master_worker: %s" % json.dumps(metrics))
    return metrics, launches


# ------------------------------------------------ serving modes (phase 23)

MODES_DRAFT_K = 2  # bench.py's spec_gamma
MODES_DRAFT_LAYERS = 2  # bench.py:567's spec_draft_layers
MODES_CHUNK = 128  # chunked prefill's tile, in tokens
MODES_BUDGET_MS = 8.0  # the scheduler's per-tick tile budget (the default)
MODES_ACCEPT_MIN = 0.85  # the self-draft's acceptance at bf16
MODES_LONG_PROMPT, MODES_LONG_NEW = 512, 32  # submitted after the 16
# the fp32 exactness check: this many of the 16 requests, their new
# tokens cut to MODES_EXACT_NEW, so that the CPU's run stays short
MODES_EXACT_REQUESTS, MODES_EXACT_NEW = 6, 24
MODES_RELOAD_POLL_S = 0.05
MODES_RELOAD_TIMEOUT_S = 120


def _tile_log(engine):
    """Records (tile width in rows, profiler phase) of every prompt tile a
    paged engine runs (suffix tiles and chunked-prefill tiles): a tile of
    more than SPLIT_MAX_ROWS rows launches B's tile kernel, a narrower
    one its split kernel."""
    log = []
    inner = getattr(engine, "_tile", None)
    if inner is None:
        return log

    def tile(slot, request, start, t, phase, final=True):
        log.append((engine._suffix_bucket(t), phase))
        return inner(slot, request, start, t, phase, final=final)

    engine._tile = tile
    return log


def _kv_names(model):
    """The launch-count names of A, B split and B tile for `model`."""
    suffix = "_int8" if model.kv_cache_dtype == "int8" else ""
    return "flash_fwd", "paged_decode" + suffix, "paged_decode_tile" + suffix


def _long_gap_ms(sched, req):
    """The longest time between the ends of two decode steps whose span
    overlaps `req`'s prefill (from its seat to its first token): how long
    the other slots waited behind it."""
    ends = sched.step_ends
    gaps = [b - a for a, b in zip(ends, ends[1:])
            if b >= req.seated_at and a <= req.first_token_at]
    return max(gaps) * 1e3 if gaps else None


def run_mode(model, specs, config, draft=None, long_req=None, held=False):
    """Serve `specs` (greedy (prompt, new) pairs, then `long_req` if
    given) through a GenerationServer around `model` with
    ServingConfig(num_slots=8, kv_block_size=16, **config), after one
    warm-up request; `held`: all admitted while the scheduler waits on a
    held job, so two runs seat and batch alike. Returns the run's
    metrics (on the card also the allocator's bytes at the pass's start
    and its peak over the pass), streams, launches, tile log, requests
    and server."""
    device = model.device.type
    server = GenerationServer(model, ServingConfig(
        num_slots=8, queue_capacity=64, kv_block_size=16, kv_shared=True,
        **config), draft=draft).start()
    engine, sched = server.engine, server.scheduler
    tiles = _tile_log(engine)
    try:
        server.generate([1, 2, 3, 4], 4)
        n_steps, n_ttft = len(sched.step_secs), len(sched.ttft_secs)
        ticks0, prop0 = len(sched.step_secs), engine.draft_proposed
        acc0, tiles0 = engine.draft_accepted, sched.prefill_tiles
        del tiles[:]
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start_bytes = torch.cuda.memory_allocated()
        att.reset_launch_counts()
        t0 = time.perf_counter()
        release = _hold_scheduler(server) if held else (lambda: None)
        reqs = [server.submit(p, n) for p, n in specs]
        if long_req is not None:
            reqs.append(server.submit(*long_req))
        release()
        in_use = 0
        for req in reqs:
            for _chunk in server.events(req):
                pass
            in_use = max(in_use, engine.kv_stats()["kv_bytes_in_use"])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(att.KERNEL_LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    finally:
        server.stop(timeout=120)
    check(server.scheduler.crashed is None,
          "scheduler crashed: %r" % (server.scheduler.crashed,))
    wanted = list(specs) + ([long_req] if long_req is not None else [])
    for req, (prompt, new) in zip(reqs, wanted):
        check(len(req.generated) == new, "request %d finished with %d of %d "
              "tokens" % (req.request_id, len(req.generated), new))
    steps = np.asarray(sched.step_secs[n_steps:]) * 1e3
    ttft = np.asarray(sched.ttft_secs[n_ttft:]) * 1e3
    tokens = sum(len(r.generated) for r in reqs)
    a, split, tile = _kv_names(model)
    kv = engine.kv_stats()
    metrics = {
        "requests": len(reqs), "tokens_generated": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "step_ms_p50": float(np.percentile(steps, 50)),
        "step_ms_p99": float(np.percentile(steps, 99)),
        "steps": int(steps.size),
        "tokens_per_step": float(np.sum(sched.step_tokens[n_steps:])
                                 / max(1, steps.size)),
        "decode_tokens_per_s": float(np.sum(sched.step_tokens[n_steps:])
                                     / max(1e-9, np.sum(steps) / 1e3)),
        "kv_paged": kv["kv_paged"], "kv_cache_dtype": kv["kv_cache_dtype"],
        "kv_bytes_total": kv["kv_bytes_total"],
        "kv_bytes_in_use_peak": in_use,
        "launches": {"flash_fwd": launches[a], "paged_split": launches[split],
                     "paged_tile": launches[tile]},
    }
    if device == "cuda":
        metrics.update(start_allocated_bytes=start_bytes,
                       peak_allocated_bytes=peak,
                       peak_over_start_bytes=peak - start_bytes)
    if long_req is not None:
        metrics["long_prompt_tokens"] = len(long_req[0])
        metrics["long_prompt_ttft_ms"] = (
            reqs[-1].first_token_at - reqs[-1].submitted_at) * 1e3
        metrics["long_prompt_decode_wait_ms"] = _long_gap_ms(sched, reqs[-1])
    if engine.draft_k:
        proposed = engine.draft_proposed - prop0
        accepted = engine.draft_accepted - acc0
        metrics.update(draft_k=engine.draft_k, proposed=proposed,
                       accepted=accepted,
                       acceptance=accepted / max(1, proposed),
                       ticks=len(sched.step_secs) - ticks0)
    if engine.prefill_chunk_tokens:
        metrics["prefill_tiles"] = sched.prefill_tiles - tiles0
    if engine.profiler is not None:
        metrics["profile"] = engine.profiler.snapshot()
    return {"metrics": metrics, "streams": [list(r.generated) for r in reqs],
            "launches": launches, "tiles": list(tiles), "requests": reqs,
            "server": server}


def _hold_scheduler(server):
    """Hold `server`'s scheduler on a job until the returned release() is
    called: requests submitted meanwhile are seated in one order."""
    held, go = threading.Event(), threading.Event()

    def hold_job():
        held.set()
        go.wait(MODES_RELOAD_TIMEOUT_S)

    hold = threading.Thread(target=server.scheduler.submit_job, args=(
        hold_job, MODES_RELOAD_TIMEOUT_S + 20), daemon=True)
    hold.start()
    check(held.wait(60), "the scheduler did not take the hold job")

    def release():
        go.set()
        hold.join(timeout=60)

    return release


def _resident_bytes(model):
    """Bytes of `model`'s parameters and buffers, each storage once."""
    seen, total = set(), 0
    for t in itertools.chain(model.parameters(), model.buffers()):
        storage = t.untyped_storage()
        if storage.data_ptr() not in seen:
            seen.add(storage.data_ptr())
            total += storage.nbytes()
    return total


def _check_mode_launches(name, run, layers, draft_layers=0):
    """Each kernel's launches in a mode's run, from what the run did: B's
    split kernel once a layer a decode step (or speculative verify) and a
    tile of up to SPLIT_MAX_ROWS rows, its tile kernel once a layer a
    wider tile, A once a layer a monolithic prefill (the target's, and
    the draft's at every seat); the dense engine launches no B."""
    m = run["metrics"]
    got = m["launches"]
    small = sum(1 for rows, _ph in run["tiles"] if rows <= att.SPLIT_MAX_ROWS)
    wide = len(run["tiles"]) - small
    seats = m["requests"]
    if not m["kv_paged"]:
        want = {"flash_fwd": layers * seats, "paged_split": 0,
                "paged_tile": 0}
    else:
        mono = seats - sum(1 for _r, ph in run["tiles"]
                           if ph == "suffix_tile")
        if m.get("prefill_tiles"):
            mono = 0  # every prompt of the run is chunked
        want = {"flash_fwd": layers * mono + draft_layers * seats,
                "paged_split": layers * (m["steps"] + small),
                "paged_tile": layers * wide}
    m["launches_expected"] = want
    log("serving mode %s: launches %s, from the run %s (steps %d, tiles "
        "%d narrow / %d wide)" % (name, got, want, m["steps"], small, wide))
    check(got == want, "serving mode %s launched %s, not %s"
          % (name, got, want))


def _first_divergence(got, ref):
    for i, (x, y) in enumerate(zip(got, ref)):
        if x != y:
            return i
    return None if len(got) == len(ref) else min(len(got), len(ref))


def near_tie_gaps(model, prompts, ref_streams, streams_by_mode):
    """Each mode's streams against the reference run's: the identical
    count, and for every stream that differs, the gap between the
    reference's top two logits at the first divergent position over the
    largest |logit| there (logits_trace, one per diverging request, fed
    the reference's tokens). A divergence must be a near-tie: gap within
    LOGIT_TOL_REL."""
    first = {}
    for mode, streams in streams_by_mode.items():
        for r, (got, ref) in enumerate(zip(streams, ref_streams)):
            i = _first_divergence(got, ref)
            if i is not None:
                first.setdefault(r, {})[mode] = i
    out = {mode: {"identical": len(ref_streams), "gaps": []}
           for mode in streams_by_mode}
    for r, modes in sorted(first.items()):
        prefill, steps, _fed, _rows = logits_trace(
            model, prompts[r], ref_streams[r][:max(modes.values())])
        for mode, i in modes.items():
            lg = prefill[len(prompts[r]) - 1] if i == 0 else steps[i - 1]
            top = torch.topk(lg, 2).values
            gap = ((top[0] - top[1]) / lg.abs().max()).item()
            out[mode]["identical"] -= 1
            out[mode]["gaps"].append({"request": r, "position": i,
                                      "gap_rel": gap})
    for mode, res in out.items():
        log("serving mode %s: %d of %d streams identical to the reference; "
            "first-divergence top-2 gaps %s" % (
                mode, res["identical"], len(ref_streams),
                [round(g["gap_rel"], 6) for g in res["gaps"]]))
        for g in res["gaps"]:
            check(g["gap_rel"] <= LOGIT_TOL_REL,
                  "serving mode %s: request %d diverges at %d where the "
                  "reference's top two logits are %.4g of the largest apart "
                  "(limit %.4g)" % (mode, g["request"], g["position"],
                                    g["gap_rel"], LOGIT_TOL_REL))
    return out


def modes_exact_fp32(specs, device="cuda"):
    """The flagship width at 2 layers in fp32 (numpy weights, TF32 off):
    the plain paged engine, the dense engine, speculative decode with a
    random 2-layer draft and with the target as its own draft, chunked
    prefill and the profiled engine on the card, and the plain paged
    engine on the CPU, over the first MODES_EXACT_REQUESTS requests cut
    to MODES_EXACT_NEW new tokens: every greedy stream identical."""
    cfg = dict(FLAGSHIP, num_layers=2, dtype=torch.float32)
    sd = params_from_flax(numpy_flax_params(cfg, seed=23))
    reqs = [(p, min(n, MODES_EXACT_NEW))
            for p, n in specs[:MODES_EXACT_REQUESTS]]

    def model(dev, seed=None):
        m = TransformerLM(device=dev, **cfg)
        if seed is None:
            m.load_state_dict(sd)
        else:
            m.init_weights(seed)
        return m

    target = model(device)
    modes = {
        "paged": ({"kv_paged": True}, None),
        "dense": ({"kv_paged": False}, None),
        "speculative_random_draft": ({"kv_paged": True,
                                      "draft_k": MODES_DRAFT_K},
                                     model(device, seed=1)),
        "speculative_self_draft": ({"kv_paged": True,
                                    "draft_k": MODES_DRAFT_K}, target),
        "chunked": ({"kv_paged": True, "prefill_chunk_tokens": MODES_CHUNK,
                     "prefill_budget_ms": MODES_BUDGET_MS}, None),
        "profiled": ({"kv_paged": True, "profile": True}, None),
    }
    streams = {mode: run_mode(target, reqs, config, draft=draft)["streams"]
               for mode, (config, draft) in modes.items()}
    streams["paged_cpu"] = run_mode(model("cpu"), reqs,
                                    {"kv_paged": True})["streams"]
    ref = streams["paged"]
    equal = {mode: s == ref for mode, s in streams.items()}
    log("fp32 2-layer exactness, streams equal to the card's paged run: %s"
        % equal)
    check(all(equal.values()), "fp32 greedy streams differ between modes: "
          "%s" % {m: s for m, s in streams.items() if s != ref})
    return {"config": "flagship width, 2 layers, fp32, TF32 off, numpy "
                      "weights", "requests": len(reqs),
            "tokens": sum(map(len, ref)), "streams_equal": equal}


def _reload_server(ckpt, params, device):
    return serving_main.build_server(serving_main.parse_serving_args([
        "--device", device, "--model_params", params, "--checkpoint_dir",
        ckpt, "--kv_paged", "1", "--num_slots", "8", "--kv_block_size", "16",
        "--reload_poll_secs", str(MODES_RELOAD_POLL_S)]))


def modes_hot_reload(specs, workdir, device="cuda"):
    """A server built by serving/main.py follows a checkpoint dir holding
    version 1 (a port Trainer's seeded flagship parameters, SGD, no
    slots); while 8 requests decode, version 2 (re-seeded parameters) is
    written; the watcher swaps between steps. No stream may drop a token;
    every live weight must equal version 2's fp32 value cast to its dtype
    bit for bit; a request admitted after the swap reports version 2 and
    its greedy tokens equal a fresh server's over version 2."""
    from elasticdl_tpu_torch.training.optimizers import sgd

    params = _params_str(FLAGSHIP)
    spec = load_model_spec_from_module(tzoo)
    spec.optimizer = lambda: sgd(0.01)
    trainer = Trainer(spec, model_params=params, device=device, seed=3)
    state = trainer.init_state(None)
    ckpt = os.path.join(workdir, "reload")
    staged = os.path.join(workdir, "staged")
    CheckpointSaver(trainer, ckpt).save(state, 1)
    # version 2 is written beside the dir and renamed into it while the
    # requests decode, as a saver's own rename lands a version
    trainer.model.init_weights(4)
    t0 = time.perf_counter()
    CheckpointSaver(trainer, staged).save(state, 2)
    save_s = time.perf_counter() - t0
    del trainer, state
    server = _reload_server(ckpt, params, device)
    check(server.model_version == 1, "the server starts at version %d"
          % server.model_version)
    server.start()
    sched = server.scheduler
    try:
        server.generate([1, 2, 3, 4], 4)
        reqs = [server.submit(p, n) for p, n in specs[:8]]
        streams = [server.events(r) for r in reqs]
        got = [list(next(s)) for s in streams]  # all 8 are decoding
        os.rename(os.path.join(staged, "version-2"),
                  os.path.join(ckpt, "version-2"))
        t_written = time.monotonic()
        for g, s in zip(got, streams):
            for chunk in s:
                g.extend(chunk)
        deadline = time.monotonic() + MODES_RELOAD_TIMEOUT_S
        while server.model_version != 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        check(server.model_version == 2, "the server did not swap to "
              "version 2: %s" % server.status())
        dropped = sum(n for _p, n in specs[:8]) - sum(map(len, got))
        later = server.submit(*specs[8])
        later_tokens = list(itertools.chain(*server.events(later)))
        flat2, _v = load_checkpoint(ckpt, 2)
        swapped = _weights_equal_cast(server.engine.model, flat2)
        status = server.status()
    finally:
        server.stop(timeout=120)
    check(sched.crashed is None, "scheduler crashed: %r" % (sched.crashed,))
    check(dropped == 0, "hot reload dropped %d tokens" % dropped)
    check(sched.reload_in_flight and sched.reload_in_flight[0] > 0,
          "the swap landed with no request decoding")
    check(later.model_version == 2, "a request after the swap reports "
          "version %d" % later.model_version)
    check(swapped["equal"], "after the swap %d weights differ from version "
          "2's cast: %s" % (len(swapped["differ"]), swapped["differ"][:5]))
    fresh = _reload_server(ckpt, params, device).start()
    try:
        check(fresh.model_version == 2, "the fresh server serves version %d"
              % fresh.model_version)
        fresh_tokens = fresh.generate(*specs[8])[len(specs[8][0]):]
    finally:
        fresh.stop(timeout=120)
    check(later_tokens == fresh_tokens, "after the swap a request's tokens "
          "differ from a fresh server's over version 2")
    # the swap's stall: the longest gap between decode steps from the
    # write to the end of the in-flight streams (the watcher's verify and
    # load run on the scheduler thread, then the in-place copy)
    ends = [e for e in sched.step_ends if e >= t_written]
    stall = max((b - a for a, b in zip(ends, ends[1:])), default=0.0)
    return {
        "versions": [1, status["model_version"]], "reloads": status["reloads"],
        "swap_ms": [s * 1e3 for s in sched.reload_secs],
        "in_flight_at_swap": sched.reload_in_flight[0],
        "save_s": save_s, "decode_stall_ms": stall * 1e3,
        "tokens_dropped": dropped, "streams": len(reqs),
        "later_request_version": later.model_version,
        "later_equals_fresh_server": later_tokens == fresh_tokens,
        "weights_equal_cast": swapped["equal"],
        "weights_checked": swapped["checked"],
        "weight_dtypes": swapped["dtypes"],
    }


def _weights_equal_cast(model, flat):
    """Every parameter of `model` against the checkpoint's value cast to
    that parameter's dtype (a flax kernel transposed), bit for bit."""
    from elasticdl_tpu_torch.convert import flax_param_path

    differ, dtypes = [], set()
    for key, p in model.named_parameters():
        path = flax_param_path(key).split("/")
        value = torch.as_tensor(np.asarray(flat[".params" + "".join(
            "[%r]" % k for k in path)])).to(p.device)
        if path[-1] == "kernel":
            value = value.t()
        dtypes.add(str(p.dtype))
        if not torch.equal(p.detach(), value.to(p.dtype)):
            differ.append(key)
    return {"equal": not differ, "differ": differ,
            "checked": len(list(model.parameters())),
            "dtypes": sorted(dtypes)}


def time_verify_tile(launches):
    """B's split kernel at the speculative verify tile's shape: 8 slots,
    t = MODES_DRAFT_K + 1 rows each, ragged lengths under 1000, against
    its plain version and timed as the decode step's row of `kernels`."""
    t = MODES_DRAFT_K + 1
    args, lens = paged_inputs(torch.Generator().manual_seed(
        PAGED_TIMING_SEED + 23), b=8, t=t)
    errs = partials_errs(att.paged_decode_partials(*args, t=t),
                         att.paged_decode_partials_plain(*args, t=t))
    check(max(errs) <= PAGED_TOL_REL, "B's split kernel at the verify tile: "
          "rel errs %s" % errs)
    entry = _timing_entry(
        "paged_decode", "elasticdl_tpu_torch/csrc/paged_decode.cu",
        "elasticdl_tpu/ops/attention.py:591",
        "b=8 t=%d (the speculative verify tile) hkv=8 d=128 bs=16 m=64 bf16, "
        "live rows %d" % (t, sum(lens)),
        lambda: att.paged_decode_partials(*args, t=t),
        lambda: att.paged_decode_partials_plain(*args, t=t),
        None, paged_work(lens, 8, t, 128, 2, 64), launches,
        {"max_abs_err": errs[0], "max_rel_err": max(errs)},
        peak=PEAK_FP32_FLOPS)
    entry["path"] = "speculative verify (serving_modes)"
    return paged_cold(entry, args, t=t)


def serving_modes_phase(specs, int8_ref_streams, workdir, device="cuda"):
    """Phase 23: the serving engine's other modes at the flagship width
    (bf16, seeded weights, 8 slots, block 16): the plain paged engine
    (the reference), the dense engine with a bf16 and an int8 cache,
    speculative decode (k = MODES_DRAFT_K) with a random 2-layer draft
    and with the target as its own draft, chunked prefill, the profiled
    engine and hot reload; the 16 requests and one 512-token prompt
    submitted after them. Then the fp32 exactness check. Returns the
    `serving_modes` line. Off the card (a rehearsal at a small width)
    the launch checks are skipped."""
    on_card = device == "cuda"
    rng = np.random.RandomState(23)
    layers = FLAGSHIP["num_layers"]
    long_req = (rng.randint(0, FLAGSHIP["vocab_size"],
                            size=MODES_LONG_PROMPT).tolist(), MODES_LONG_NEW)
    model = TransformerLM(device=device, seed=0, **FLAGSHIP)
    draft = TransformerLM(device=device, seed=1, **dict(
        FLAGSHIP, num_layers=MODES_DRAFT_LAYERS))
    chunked_cfg = {"kv_paged": True, "prefill_chunk_tokens": MODES_CHUNK,
                   "prefill_budget_ms": MODES_BUDGET_MS}
    spec_cfg = {"kv_paged": True, "draft_k": MODES_DRAFT_K}
    runs = {}
    for name, config, mode_draft, draft_layers in (
            ("paged", {"kv_paged": True}, None, 0),
            ("dense", {"kv_paged": False}, None, 0),
            ("speculative_random_draft", spec_cfg, draft, MODES_DRAFT_LAYERS),
            ("speculative_self_draft", spec_cfg, model, layers),
            ("chunked", chunked_cfg, None, 0),
            ("profiled", {"kv_paged": True, "profile": True}, None, 0),
            ("profiled_speculative_self_draft", dict(spec_cfg, profile=True),
             model, layers),
            ("profiled_chunked", dict(chunked_cfg, profile=True), None, 0)):
        runs[name] = run_mode(model, specs, config, draft=mode_draft,
                              long_req=long_req)
        if on_card:
            _check_mode_launches(name, runs[name], layers, draft_layers)
        log("serving mode %s: %s" % (name, json.dumps(runs[name]["metrics"])))
    del draft
    int8_model = TransformerLM(device=device, seed=0, kv_cache_dtype="int8",
                               **FLAGSHIP)
    runs["dense_int8"] = run_mode(int8_model, specs, {"kv_paged": False},
                                  long_req=long_req)
    if on_card:
        _check_mode_launches("dense_int8", runs["dense_int8"], layers)
    prompts = [p for p, _n in specs]
    ref = runs["paged"]["streams"][:len(specs)]
    agreement = near_tie_gaps(model, prompts, ref, {
        name: run["streams"][:len(specs)] for name, run in runs.items()
        if name not in ("paged", "dense_int8")})
    agreement.update(near_tie_gaps(int8_model, prompts, int8_ref_streams, {
        "dense_int8": runs["dense_int8"]["streams"][:len(specs)]}))
    del int8_model
    out = {name: run["metrics"] for name, run in runs.items()}
    for name, res in agreement.items():
        out[name]["agreement"] = dict(
            res, reference="the plain paged engine's %s run" % (
                "int8 (phase 7)" if name == "dense_int8" else "bf16"))
    plain = out["paged"]
    for name in ("speculative_random_draft", "speculative_self_draft",
                 "profiled_speculative_self_draft"):
        m = out[name]
        batches = runs[name]["server"].scheduler.step_batch[-m["ticks"]:]
        check(m["proposed"] == MODES_DRAFT_K * sum(batches),
              "%s proposed %d, not k x active slots summed over ticks"
              % (name, m["proposed"]))
        m["verify_tick_ms_p50"] = m["step_ms_p50"]
        m["plain_step_ms_p50"] = plain["step_ms_p50"]
        m["tokens_per_s_vs_plain"] = m["tokens_per_s"] / plain["tokens_per_s"]
    check(out["speculative_self_draft"]["acceptance"] >= MODES_ACCEPT_MIN,
          "the self-draft accepted %.3f of its proposals (at least %.2f)"
          % (out["speculative_self_draft"]["acceptance"], MODES_ACCEPT_MIN))
    out["chunked"]["monolithic_long_prompt_decode_wait_ms"] = plain[
        "long_prompt_decode_wait_ms"]
    out["chunked"]["monolithic_long_prompt_ttft_ms"] = plain[
        "long_prompt_ttft_ms"]
    del runs
    if on_card:
        out["dense"]["decode_profile"] = profile_decode(rng, dense=True)
        log("dense decode profile: %s"
            % json.dumps(out["dense"]["decode_profile"]))
    out["hot_reload"] = modes_hot_reload(specs, workdir, device)
    log("hot reload: %s" % json.dumps(out["hot_reload"]))
    out["exact_fp32"] = modes_exact_fp32(specs, device)
    out["config"] = {
        "model": "transformer_lm flagship (vocab 32000, seq_len 1024, embed "
                 "1024, 8 heads, 8 layers, bf16), seeded weights",
        "slots": 8, "kv_block_size": 16, "requests": len(specs) + 1,
        "draft_k": MODES_DRAFT_K, "draft_layers": MODES_DRAFT_LAYERS,
        "prefill_chunk_tokens": MODES_CHUNK,
        "prefill_budget_ms": MODES_BUDGET_MS,
        "long_prompt": [MODES_LONG_PROMPT, MODES_LONG_NEW]}
    return out


# ------------------------------------------------------------------
# phase 25: the lifecycle after pretraining (fine-tune, export, int8,
# offline generation)

LIFE_REMAT_STEPS = 2  # steps a remat mode takes, on the same batches
LIFE_LORA_RANK = 8
LIFE_LORA_STEPS = 4
LIFE_WORKER_RECORDS = 16  # phase 22's first records: one task, 2 steps
# the merged dense model's logits against the adapter model's, both in
# fp32 (TF32 off): they differ only in where (x A) B * s is summed
LIFE_MERGE_TOL_REL = 1e-4
LIFE_BEAMS, LIFE_BEAM_PROMPT, LIFE_BEAM_NEW = 4, 32, 16
LIFE_DRAFT_LAYERS = 2
LIFE_DISTILL_LEN, LIFE_DISTILL_BATCH, LIFE_DISTILL_EPOCHS = 128, 4, 10
LIFE_DISTILL_WINDOWS = 16  # 4 batches a pass
LIFE_DISTILL_LR = 1e-3
LIFE_GAMMA = 4
LIFE_SPEC_ROWS, LIFE_SPEC_PROMPT, LIFE_SPEC_NEW = 4, 128, 64
# the mismatched draft: the 2-layer target with block_1's mlp_down
# kernel scaled by this (0.348 of its proposals accepted over 48 new
# tokens in a CPU run of the same weights)
LIFE_MISMATCH_SCALE = 0.9


def _life_batches(rng, n):
    """n training batches of TRAIN_BATCH rows of seq_len + 1 tokens."""
    cfg = FLAGSHIP
    out = []
    for _ in range(n):
        t = rng.randint(0, cfg["vocab_size"], size=(
            TRAIN_BATCH, cfg["seq_len"] + 1)).astype(np.int32)
        out.append(({"tokens": t[:, :-1]}, t[:, 1:]))
    return out


def _life_steps(trainer, state, batches, device):
    """Train on `batches`: (state, losses, each step's launches of A, C
    and D, each step's peak bytes allocated over what was allocated when
    it began, each step's wall ms). The first step's peak also holds the
    optimizer's first allocation of its slots; the later ones are a
    training step's own (activations, the loss, gradients)."""
    losses, launches, peaks, ms = [], [], [], []
    on_card = device == "cuda"
    for batch in batches:
        before = dict(att.KERNEL_LAUNCHES)
        _sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated() if on_card else 0
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        peaks.append(int(torch.cuda.max_memory_allocated()) - start
                     if on_card else 0)
        losses.append(loss)
        launches.append({k: att.KERNEL_LAUNCHES[k] - before[k]
                         for k in TRAINING_KERNELS})
    return state, losses, launches, peaks, ms


def _life_check_launches(part, launches, layers, a_per_layer, on_card):
    if not on_card:
        return
    want = {"flash_fwd": a_per_layer * layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers}
    for i, got in enumerate(launches):
        got = {k: got[k] for k in want}
        check(got == want, "lifecycle %s step %d launched %s, not %s"
              % (part, i + 1, got, want))


def _timed(fn, device):
    """(fn(), its wall seconds), the card synchronized around it."""
    _sync(device)
    t = time.perf_counter()
    res = fn()
    _sync(device)
    return res, time.perf_counter() - t


def _life_tie_gaps(model, ref, got, p):
    """Rows of `got` that leave the greedy `ref` tokens: each first
    divergence with the gap of the greedy run's top two logits there
    (a prefill over the greedy prefix) over the largest |logit|; each
    must be within LOGIT_TOL_REL."""
    gaps = []
    for r in range(ref.shape[0]):
        i = _first_divergence(got[r].tolist(), ref[r].tolist())
        if i is None:
            continue
        with torch.no_grad():
            lg = model(ref[r:r + 1, :i].to(model.device))[0][0, -1].float()
        top = torch.topk(lg, 2).values
        gap = ((top[0] - top[1]) / lg.abs().max()).item()
        gaps.append({"row": r, "position": i - p, "gap_rel": gap})
        check(gap <= LOGIT_TOL_REL, "lifecycle: speculative row %d leaves "
              "greedy at new token %d where its top two logits are %.4g of "
              "the largest apart (limit %.4g)" % (r, i - p, gap,
                                                  LOGIT_TOL_REL))
    return gaps


class _TimedExporter(SavedModelExporter):
    """SavedModelExporter that keeps the seconds its export took."""

    seconds = None

    def on_train_end(self, worker):
        t0 = time.perf_counter()
        super().on_train_end(worker)
        self.seconds = time.perf_counter() - t0


def lifecycle_phase(specs, job, workdir, device="cuda"):
    """Phase 25 (see the module docstring): remat, a LoRA warm start from
    a dense checkpoint, merge and export at a Worker's train end, int8
    weights served, beam search, a distilled draft's speculative decode.
    Returns (the `lifecycle` line, launches by part). Off the card (a
    rehearsal at a small width) the launch and memory checks are
    skipped."""
    on_card = device == "cuda"
    rng = np.random.RandomState(25)
    layers = FLAGSHIP["num_layers"]
    spec = load_model_spec_from_module(tzoo)
    out = {"config": {
        "model": "transformer_lm flagship (vocab %d, seq_len %d, embed %d, "
                 "%d heads, %d layers, bf16 over fp32 parameters), seeded "
                 "weights" % (FLAGSHIP["vocab_size"], FLAGSHIP["seq_len"],
                              FLAGSHIP["embed_dim"], FLAGSHIP["num_heads"],
                              layers),
        "minibatch": TRAIN_BATCH, "lora_rank": LIFE_LORA_RANK,
        "lora_alpha": 16.0, "trainable_pattern": "lora"}}
    launches = {}
    batches = _life_batches(rng, LIFE_REMAT_STEPS + LIFE_LORA_STEPS)
    # 1. remat: the same steps from the same state under "", full, dots
    t0 = time.perf_counter()
    remat = {}
    ref = None
    dense_ckpt = os.path.join(workdir, "lifecycle_dense")
    for mode in ("", "full", "dots"):
        if on_card:
            torch.cuda.empty_cache()
        trainer = Trainer(spec, model_params=_params_str(dict(
            FLAGSHIP, remat=mode)), device=device)
        state = trainer.init_state(None)
        att.reset_launch_counts()
        state, losses, steps, peak, ms = _life_steps(
            trainer, state, batches[:LIFE_REMAT_STEPS], device)
        _life_check_launches("remat %r" % mode, steps, layers,
                             2 if mode else 1, on_card)
        launches["remat_" + (mode or "off")] = steps
        remat[mode or "off"] = {"losses": losses,
                                "step_peak_bytes_over_start": peak,
                                "step_ms": ms}
        if not mode:
            ref = {k: p.detach().clone() for k, p in state.params.items()}
            ref_losses = losses
            # the dense model's loss on the LoRA run's first batch, with
            # the weights of the train step (ones)
            feats, labels = batches[LIFE_REMAT_STEPS]
            with torch.no_grad():
                dense_loss = float(tzoo.loss(
                    torch.as_tensor(labels, device=trainer.device),
                    trainer.model(trainer._features(feats), training=True),
                    torch.ones(TRAIN_BATCH, device=trainer.device)))
            saver = CheckpointSaver(trainer, dense_ckpt)
            saver.save(state, state.step)
            dense_version = state.step
        else:
            check(losses == ref_losses, "lifecycle: remat %r losses %s, "
                  "remat '' %s" % (mode, losses, ref_losses))
            differ = [k for k, p in state.params.items()
                      if not torch.equal(p, ref[k])]
            check(not differ, "lifecycle: remat %r parameters differ from "
                  "remat '' in %d tensors, e.g. %s" % (mode, len(differ),
                                                       differ[:3]))
        del trainer, state
    # a step's own peak: the last step's (the first also allocates the
    # optimizer's slots)
    remat["step_peak_vs_off"] = {
        m: remat[m]["step_peak_bytes_over_start"][-1] / max(1, remat["off"][
            "step_peak_bytes_over_start"][-1]) for m in ("full", "dots")}
    remat["seconds"] = time.perf_counter() - t0
    out["remat"] = remat
    log("lifecycle remat: %s" % json.dumps(remat))
    # 2. LoRA warm start from the dense checkpoint, adapters only
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
    lora_params = _params_str(dict(FLAGSHIP, lora_rank=LIFE_LORA_RANK,
                                   remat="full"))
    trainer = Trainer(spec, model_params=lora_params, device=device,
                      trainable_pattern="lora")
    state = trainer.init_state(None)
    t1 = time.perf_counter()
    state, version = restore_state_from_checkpoint(trainer, state,
                                                   dense_ckpt, strict=False)
    restore_s = time.perf_counter() - t1
    check(version == dense_version, "lifecycle: restored version %d"
          % version)
    adapters = {k: p.detach().clone() for k, p in state.params.items()
                if "lora" in k}
    att.reset_launch_counts()
    state, losses, steps, peak, ms = _life_steps(
        trainer, state, batches[LIFE_REMAT_STEPS:], device)
    _life_check_launches("LoRA", steps, layers, 2, on_card)
    launches["lora"] = steps
    check(losses[0] == dense_loss, "lifecycle: the warm-started LoRA model's "
          "first loss %r, the dense model's %r" % (losses[0], dense_loss))
    moved_base = [k for k, r in ref.items() if not torch.equal(
        state.params[k], r)]
    check(not moved_base, "lifecycle: LoRA training moved %d base tensors, "
          "e.g. %s" % (len(moved_base), moved_base[:3]))
    still = [k for k, a in adapters.items() if torch.equal(
        state.params[k], a)]
    check(len(adapters) == 4 * layers and not still, "lifecycle: %d "
          "adapters, %d unmoved" % (len(adapters), len(still)))
    del ref, adapters
    lora_ckpt = os.path.join(workdir, "lifecycle_lora")
    CheckpointSaver(trainer, lora_ckpt).save(state, state.step)
    lora_version = state.step
    out["lora"] = {"losses": losses, "dense_first_loss": dense_loss,
                   "restore_s": restore_s,
                   "step_peak_bytes_over_start": peak,
                   "step_ms": ms,
                   "trainable_params": sum(
                       p.numel() for k, p in state.params.items()
                       if k in trainer.train_names),
                   "seconds": time.perf_counter() - t0}
    log("lifecycle LoRA: %s" % json.dumps(out["lora"]))
    del trainer, state
    # 3. train end of an in-process Worker: merge_lora, then the export
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
    data = os.path.join(workdir, "lifecycle_train")
    os.makedirs(data)
    shard = os.path.join(job["data"], "tokens-00000.trec")
    with RecordWriter(os.path.join(data, "tokens-00000.trec")) as w:
        for record in Scanner(shard, 0, LIFE_WORKER_RECORDS):
            w.write(record)
    export_dir = os.path.join(workdir, "lifecycle_export")
    exporter_cb = _TimedExporter(export_dir, merge_lora=True)
    master = Master(spec, training_data=data, minibatch_size=TRAIN_BATCH,
                    records_per_task=LIFE_WORKER_RECORDS,
                    export_saved_model=True)
    master.prepare()
    worker = None
    try:
        worker = Worker(0, spec, master_addr="localhost:%d" % master.port,
                        minibatch_size=TRAIN_BATCH, training_data=data,
                        model_params=lora_params, wait_sleep_secs=0.05,
                        device=device, trainable_pattern="lora",
                        checkpoint_dir_for_init=lora_ckpt,
                        callbacks=[exporter_cb])
        wsteps = _record_steps(worker, device)
        att.reset_launch_counts()
        _mw_run_bounded(worker.run, "the lifecycle worker")
        _sync(device)
        check(master.task_d.finished() and worker.job_complete,
              "lifecycle: the worker's job did not complete")
    finally:
        master.stop()
        if worker is not None:
            worker.close()
    worker_steps = LIFE_WORKER_RECORDS // TRAIN_BATCH
    check(worker.restored_version == lora_version
          and worker.state.step == lora_version + worker_steps
          and len(wsteps) == worker_steps, "lifecycle: the worker restored "
          "%r and ended at step %d" % (worker.restored_version,
                                       worker.state.step))
    _life_check_launches("worker", [s["launches"] for s in wsteps],
                         layers, 2, on_card)
    launches["worker"] = [{k: s["launches"][k] for k in TRAINING_KERNELS}
                          for s in wsteps]
    check(exporter_cb.seconds is not None, "lifecycle: no export at the "
          "worker's train end")
    merged = merge_lora(flax_tree(worker.trainer.model,
                                  worker.state.params),
                        model=worker.trainer.model)
    t1 = time.perf_counter()
    payload, meta = load_exported(export_dir)
    load_s = time.perf_counter() - t1
    flat_merged, flat_export = (flatten_params(merged),
                                flatten_params(payload["params"]))
    differ = sorted(set(flat_merged) ^ set(flat_export)) + [
        k for k in flat_merged if k in flat_export and not (
            flat_export[k].dtype == flat_merged[k].dtype
            and np.array_equal(flat_export[k], flat_merged[k]))]
    check(not differ and meta["version"] == worker.state.step,
          "lifecycle: the export differs from merge_lora of the worker's "
          "state in %s (version %s)" % (differ[:3], meta.get("version")))
    export_bytes = os.path.getsize(os.path.join(export_dir, "params.msgpack"))
    # the merged dense model against the adapter model, both fp32
    fp32 = dict(FLAGSHIP, dtype=torch.float32)
    lora_fp32 = TransformerLM(device=device, lora_rank=LIFE_LORA_RANK,
                              **fp32)
    lora_fp32.load_state_dict(worker.trainer.model.state_dict())
    feats = {"tokens": batches[0][0]["tokens"][:2]}
    with torch.no_grad():
        want = lora_fp32(feats, training=False)
        del lora_fp32
        merged_fp32 = load_params(TransformerLM(device=device, **fp32),
                                  payload["params"])
        got = merged_fp32(feats, training=False)
    merge_err = rel_err(got, want)
    del merged_fp32, got, want, worker, merged, flat_merged, flat_export
    check(merge_err <= LIFE_MERGE_TOL_REL, "lifecycle: merged logits %.3g "
          "from the adapter model's (limit %g)" % (merge_err,
                                                    LIFE_MERGE_TOL_REL))
    out["export"] = {"bytes": export_bytes, "write_s": exporter_cb.seconds,
                     "load_s": load_s, "version": meta["version"],
                     "num_params": meta["num_params"],
                     "merged_vs_adapter_logits_rel_err_fp32": merge_err,
                     "worker_step_ms": [s["ms"] for s in wsteps],
                     "seconds": time.perf_counter() - t0}
    log("lifecycle export: %s" % json.dumps(out["export"]))
    # 4. int8 weights: a checkpoint of the quantized export, served by
    # serving/main.py's model from it, against the float export's streams
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    qtree = quantize_params(payload["params"])
    quantize_s = time.perf_counter() - t1
    qbytes, fbytes = quantized_bytes(qtree)
    qckpt = os.path.join(workdir, "lifecycle_int8")
    CheckpointSaver(None, qckpt).save_flat(dict(
        params_tree_leaves(qtree), **{".step": np.int32(meta["version"])}),
        meta["version"])
    int8_args = serving_main.parse_serving_args([
        "--device", device, "--model_params", _params_str(FLAGSHIP),
        "--checkpoint_dir", qckpt])
    int8_model, qversion = serving_main.build_model(int8_args)
    check(qversion == meta["version"] and int8_model.weights_int8
          and not holds_int8(int8_model), "lifecycle: the int8 checkpoint "
          "served version %d, int8 %s" % (qversion, int8_model.weights_int8))
    target = load_params(TransformerLM(device=device, **FLAGSHIP),
                         payload["params"])
    float_run = run_mode(target, specs, {"kv_paged": True})
    # the two int8 modes seat and batch alike (held admission), so their
    # bf16 products, and so their streams, must be equal; each starts
    # from a collected heap, so their peaks compare
    gc.collect()
    int8_run = run_mode(int8_model, specs, {"kv_paged": True}, held=True)
    int8_run["metrics"]["resident_weight_bytes"] = _resident_bytes(
        int8_model)
    del int8_model, int8_run["server"]  # the server holds the model
    gc.collect()  # the server's reference cycles hold its model and pool
    if on_card:
        torch.cuda.empty_cache()
    # the same checkpoint with the int8 leaves resident, dequantized inside
    # every forward (EDL_SERVING_FUSED_DEQUANT=1)
    saved = os.environ.get("EDL_SERVING_FUSED_DEQUANT")
    os.environ["EDL_SERVING_FUSED_DEQUANT"] = "1"
    try:
        fused_model, fversion = serving_main.build_model(int8_args)
    finally:
        if saved is None:
            os.environ.pop("EDL_SERVING_FUSED_DEQUANT")
        else:
            os.environ["EDL_SERVING_FUSED_DEQUANT"] = saved
    check(fversion == meta["version"] and holds_int8(fused_model),
          "lifecycle: the fused model holds no int8 leaf")
    fused_run = run_mode(fused_model, specs, {"kv_paged": True}, held=True)
    fused_run["metrics"]["resident_weight_bytes"] = _resident_bytes(
        fused_model)
    del fused_model, fused_run["server"]
    for name, run in (("float_export", float_run), ("int8_weights",
                                                    int8_run),
                      ("int8_fused", fused_run)):
        if on_card:
            _check_mode_launches("lifecycle " + name, run, layers)
        launches["serving_" + name] = run["metrics"]["launches"]
    check(fused_run["metrics"]["launches"] == int8_run["metrics"]["launches"],
          "lifecycle: the fused pass launched %s, the once-at-load pass %s"
          % (fused_run["metrics"]["launches"],
             int8_run["metrics"]["launches"]))
    check(fused_run["streams"] == int8_run["streams"], "lifecycle: the fused "
          "int8 streams leave the once-at-load ones at token %s"
          % (_first_divergence(sum(fused_run["streams"], []),
                               sum(int8_run["streams"], [])),))
    prompts = [p for p, _n in specs]
    agreement = near_tie_gaps(target, prompts, float_run["streams"],
                              {"int8_weights": int8_run["streams"]})
    fm, im = fused_run["metrics"], int8_run["metrics"]
    ratios = {key: fm[key] / im[key] for key in (
        "decode_tokens_per_s", "tokens_per_s", "ttft_ms_p50",
        "resident_weight_bytes", "peak_allocated_bytes",
        "peak_over_start_bytes") if im.get(key)}
    log("lifecycle int8 fused over once-at-load: %s" % json.dumps(ratios))
    out["int8"] = {"quantized_bytes": qbytes, "float_bytes": fbytes,
                   "ratio": qbytes / fbytes, "quantize_s": quantize_s,
                   "float_export": float_run["metrics"],
                   "int8_weights": im,
                   "agreement": agreement["int8_weights"],
                   "fused": dict(fm, streams_equal=len(specs),
                                 launches_equal=True,
                                 over_int8_weights=ratios),
                   "seconds": time.perf_counter() - t0}
    log("lifecycle int8: %s" % json.dumps(out["int8"]))
    del int8_run, fused_run
    # 5. generation: beam search at 2 layers fp32; a warm-started,
    # distilled 2-layer draft's speculative decode at the flagship
    t0 = time.perf_counter()
    gen = {}
    cfg2 = dict(FLAGSHIP, num_layers=2, dtype=torch.float32)
    small_flax = numpy_flax_params(cfg2, 25)
    small = TransformerLM(device=device, **cfg2)
    small.load_state_dict(params_from_flax(small_flax))
    prompt = rng.randint(0, FLAGSHIP["vocab_size"],
                         size=(2, LIFE_BEAM_PROMPT))
    att.reset_launch_counts()
    t1 = time.perf_counter()
    full = beam_search_generate(small, prompt, LIFE_BEAM_NEW,
                                num_beams=LIFE_BEAMS)
    t2 = time.perf_counter()
    cached = beam_search_generate(small, prompt, LIFE_BEAM_NEW,
                                  num_beams=LIFE_BEAMS, use_cache=True)
    _sync(device)
    t3 = time.perf_counter()
    launches["beam"] = {"flash_fwd": att.KERNEL_LAUNCHES["flash_fwd"]}
    check(torch.equal(full, cached), "lifecycle: beam search's cached "
          "tokens differ from its full-forward ones")
    # full: a prefill a new token; cached: one prefill
    if on_card:
        check(launches["beam"]["flash_fwd"] == 2 * (LIFE_BEAM_NEW + 1),
              "lifecycle: beam search launched A %d times"
              % launches["beam"]["flash_fwd"])
    gen["beam"] = {"config": "flagship width, 2 layers, fp32, numpy "
                             "weights", "beams": LIFE_BEAMS,
                   "rows": 2, "prompt": LIFE_BEAM_PROMPT,
                   "new": LIFE_BEAM_NEW, "full_s": t2 - t1,
                   "cached_s": t3 - t2, "tokens_equal": True}
    # speculative decode whose rounds accept part of their proposals:
    # the 2-layer target and a draft that differs from it in one product
    off = dict(small_flax)
    off["block_1/mlp_down/kernel"] = small_flax["block_1/mlp_down/kernel"] * (
        np.float32(LIFE_MISMATCH_SCALE))
    mismatched = TransformerLM(device=device, **cfg2)
    mismatched.load_state_dict(params_from_flax(off))
    mprompt = torch.as_tensor(rng.randint(0, FLAGSHIP["vocab_size"], size=(
        LIFE_SPEC_ROWS, LIFE_SPEC_PROMPT)))
    mgreedy, mgreedy_s = _timed(lambda: autoregressive_generate(
        small, mprompt, LIFE_SPEC_NEW, use_cache=True), device)
    distinct = [len(set(row[LIFE_SPEC_PROMPT:].tolist())) for row in mgreedy]
    check(min(distinct) > 1, "lifecycle: the 2-layer target's greedy rows "
          "hold %s distinct new tokens; a row of one token repeated cannot "
          "test a partial acceptance" % distinct)
    att.reset_launch_counts()
    (mtokens, mstats), mspec_s = _timed(lambda: speculative_generate(
        small, mismatched, mprompt, LIFE_SPEC_NEW, gamma=LIFE_GAMMA,
        return_stats=True), device)
    launches["speculative_mismatched"] = {
        "flash_fwd": att.KERNEL_LAUNCHES["flash_fwd"]}
    if on_card:
        check(launches["speculative_mismatched"]["flash_fwd"] == 4,
              "lifecycle: the mismatched speculative decode launched A %s "
              "times, not 4 (2 + 2 layers' prefill)"
              % launches["speculative_mismatched"])
    check(0.0 < mstats["acceptance_rate"] < 1.0
          and mstats["committed_tokens"] < LIFE_GAMMA * mstats[
              "verify_calls"], "lifecycle: the mismatched draft's rounds "
          "did not accept part of their proposals: %s" % mstats)
    mgaps = _life_tie_gaps(small, mgreedy, mtokens, LIFE_SPEC_PROMPT)
    new_tokens = LIFE_SPEC_ROWS * LIFE_SPEC_NEW
    gen["speculative_mismatched"] = dict(
        mstats, config="flagship width, 2 layers, fp32, numpy weights; the "
        "draft's block_1 mlp_down kernel scaled by %g" % LIFE_MISMATCH_SCALE,
        gamma=LIFE_GAMMA, rows=LIFE_SPEC_ROWS, prompt=LIFE_SPEC_PROMPT,
        new=LIFE_SPEC_NEW, greedy_distinct_new_tokens=distinct,
        rows_identical_to_greedy=LIFE_SPEC_ROWS - len(mgaps),
        divergences=mgaps, seconds=mspec_s, greedy_s=mgreedy_s,
        tokens_per_s_vs_greedy=mgreedy_s / mspec_s)
    del small, mismatched
    draft = TransformerLM(device=device, seed=1, **dict(
        FLAGSHIP, num_layers=LIFE_DRAFT_LAYERS))
    copied = warm_start_draft(payload["params"], draft)
    want_copied = sorted(["wte", "wpe", "ln_f", "head"] + [
        "block_%d" % i for i in range(LIFE_DRAFT_LAYERS)])
    check(copied == want_copied, "lifecycle: warm_start_draft copied %s"
          % copied)
    sprompt = torch.as_tensor(rng.randint(0, FLAGSHIP["vocab_size"], size=(
        LIFE_SPEC_ROWS, LIFE_SPEC_PROMPT)))
    greedy, greedy_s = _timed(lambda: autoregressive_generate(
        target, sprompt, LIFE_SPEC_NEW, use_cache=True), device)
    spec_runs = {}
    for when in ("warm_start", "distilled"):
        if when == "distilled":
            # windows of random tokens, the distribution the export was
            # trained on (the target's greedy rows repeat one token)
            windows = rng.randint(0, FLAGSHIP["vocab_size"], size=(
                LIFE_DISTILL_WINDOWS, LIFE_DISTILL_LEN))
            dbatches = [windows[i:i + LIFE_DISTILL_BATCH]
                        for _ in range(LIFE_DISTILL_EPOCHS)
                        for i in range(0, LIFE_DISTILL_WINDOWS,
                                       LIFE_DISTILL_BATCH)]
            att.reset_launch_counts()
            losses, distill_s = _timed(lambda: distill_draft(
                target, draft, dbatches, lr=LIFE_DISTILL_LR), device)
            launches["distill"] = {k: att.KERNEL_LAUNCHES[k]
                                   for k in TRAINING_KERNELS}
            per_pass = len(dbatches) // LIFE_DISTILL_EPOCHS
            first_pass = float(np.mean(losses[:per_pass]))
            last_pass = float(np.mean(losses[-per_pass:]))
            check(last_pass < first_pass, "lifecycle: the distillation "
                  "KL's last pass mean %.6g is not below its first's %.6g "
                  "on the same windows: %s" % (last_pass, first_pass,
                                               losses))
            if on_card:
                steps = len(dbatches)
                want = {"flash_fwd": steps * (layers + LIFE_DRAFT_LAYERS),
                        "flash_bwd_dq": steps * LIFE_DRAFT_LAYERS,
                        "flash_bwd_dkv": steps * LIFE_DRAFT_LAYERS}
                check(launches["distill"] == want, "lifecycle: distillation "
                      "launched %s, not %s" % (launches["distill"], want))
            gen["distill"] = {"steps": len(dbatches), "batch": [
                LIFE_DISTILL_BATCH, LIFE_DISTILL_LEN], "lr": LIFE_DISTILL_LR,
                "kl_first": losses[0], "kl_last": losses[-1],
                "kl_first_pass_mean": first_pass,
                "kl_last_pass_mean": last_pass,
                "losses": losses, "seconds": distill_s}
        att.reset_launch_counts()
        (tokens, stats), spec_s = _timed(lambda: speculative_generate(
            target, draft, sprompt, LIFE_SPEC_NEW, gamma=LIFE_GAMMA,
            return_stats=True), device)
        launches["speculative_" + when] = {
            "flash_fwd": att.KERNEL_LAUNCHES["flash_fwd"]}
        if on_card:
            check(launches["speculative_" + when]["flash_fwd"]
                  == layers + LIFE_DRAFT_LAYERS, "lifecycle: speculative "
                  "decode launched A %s times" % launches[
                      "speculative_" + when])
        gaps = _life_tie_gaps(target, greedy, tokens, LIFE_SPEC_PROMPT)
        spec_runs[when] = dict(stats, seconds=spec_s,
                               tokens_per_s=new_tokens / spec_s,
                               rows_identical_to_greedy=LIFE_SPEC_ROWS - len(
                                   gaps), divergences=gaps)
    gen["speculative"] = dict(
        spec_runs, gamma=LIFE_GAMMA, rows=LIFE_SPEC_ROWS,
        greedy_distinct_new_tokens=[
            len(set(row[LIFE_SPEC_PROMPT:].tolist())) for row in greedy],
        prompt=LIFE_SPEC_PROMPT, new=LIFE_SPEC_NEW,
        draft_layers=LIFE_DRAFT_LAYERS, greedy_s=greedy_s,
        greedy_tokens_per_s=new_tokens / greedy_s,
        tokens_per_s_vs_greedy={w: r["tokens_per_s"] * greedy_s / new_tokens
                                for w, r in spec_runs.items()})
    gen["seconds"] = time.perf_counter() - t0
    out["generation"] = gen
    log("lifecycle generation: %s" % json.dumps(gen))
    del target, draft, payload, qtree
    if on_card:
        torch.cuda.empty_cache()
    return out, launches


# ------------------------------------------------- phase 26: host tier

HOST_VOCAB = 5383  # frappe's vocabulary, the DeepFM zoo's input_dim
HOST_BATCH = 512
HOST_STEPS = 8  # 4 before the resume, 4 after
HOST_HELD_OUT = 256
HOST_SCALE_BATCH = 4096
HOST_SCALE_IDS = 10_000_000  # ids uniform over [1, HOST_SCALE_IDS)
HOST_SCALE_STEPS = 20
HOST_SPLIT_STEPS = 5  # host-tier steps of their own for the split
HOST_PROFILE_STEPS = 3
# the Zipf stream's exponent: skewed ids whose rows recur across steps,
# as CTR features do (the uniform stream has no reuse)
HOST_ZIPF_A = 1.2
HOST_SEED = 26
# host tier against HBM tier and card against CPU, 8 steps: each sums
# the row gradients in another order (tests/test_host_bridge.py's)
HOST_LOSS_RTOL, HOST_LOSS_ATOL = 2e-4, 2e-5
# the scale runs, 20 steps of 4096 rows apart in the same way
HOST_SCALE_LOSS_RTOL = 1e-3
# each touched row's change over the 20 steps (one SGD update of about
# 1e-5 for most rows), host tier against HBM tier, max |err| / max
# |change| per table: the two tiers sum each row's gradient in another
# order and their dense towers drift apart as the losses do; a row F
# left unmoved or a wrong row written is off by the whole change
HOST_SCALE_ROW_CHANGE_TOL_REL = 1e-3
HOST_KERNELS = ("embedding_gather", "embedding_gather_many", "row_update",
                "row_update_many")
HOST_TABLES = ("edl_embedding", "edl_id_bias")


def _host_counts():
    counts = all_launch_counts()
    return {k: counts[k] for k in HOST_KERNELS}


def _host_rows(manager):
    """{table: (ids sorted, their rows)} of a manager's stores."""
    out = {}
    for name, t in manager.tables().items():
        ids, values = t.engine.param.export_rows()
        order = np.argsort(ids)
        out[name] = (ids[order], values[order])
    return out


def _host_digest(manager):
    """{table: (row count, sha256 of the sorted ids and rows)}."""
    out = {}
    for name, (ids, values) in _host_rows(manager).items():
        h = hashlib.sha256(ids.tobytes())
        h.update(values.tobytes())
        out[name] = (int(ids.size), h.hexdigest())
    return out


def _host_executor(zoo, part, device, **kwargs):
    return LocalExecutor(
        load_model_spec_from_module(zoo), training_data=part,
        minibatch_size=HOST_BATCH,
        records_per_task=HOST_BATCH * HOST_STEPS // 2, device=device,
        **kwargs)


def _host_train(executor, parts):
    """Train over each record dir in turn (one task of HOST_STEPS // 2
    batches each); returns the losses."""
    for part in parts:
        executor.training_data = part
        executor.train()
    return list(executor.losses)


def _rel_diff(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (HOST_LOSS_ATOL / HOST_LOSS_RTOL
                                         + np.abs(b))))


def _check_close(what, got, want, rtol=HOST_LOSS_RTOL, atol=HOST_LOSS_ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    check(got.shape == want.shape and np.all(np.isfinite(got))
          and np.allclose(got, want, rtol=rtol, atol=atol),
          "%s: max abs difference %.3g over rtol %g / atol %g"
          % (what, err, rtol, atol))
    return err


def _dense_sd(model):
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


def _init_rows(ids):
    """The host stores' lazy initial rows of `ids` for both tables
    (engines seeded 0, the zoo's dims)."""
    dims = {n: c["dim"] for n, c in thost.host_embeddings().items()}
    return {name: HostEmbeddingStore(dims[name], seed=0).lookup(ids)
            for name in HOST_TABLES}


def host_parity(parts, device):
    """deepfm_host_embedding through LocalExecutor over `parts` on
    `device`, deepfm_edl_embedding beside it from the same initial
    weights and rows, and the host run again on the CPU."""
    out, launches = {}, {}
    ex = _host_executor(thost, parts[0], device)
    init = _dense_sd(ex.trainer.model)
    _sync(device)
    reset_all_launch_counts()
    t0 = time.perf_counter()
    losses = _host_train(ex, parts)
    _sync(device)
    out["host_wall_s"] = time.perf_counter() - t0
    launches["parity_host"] = _host_counts()
    check(len(losses) == HOST_STEPS and all(map(math.isfinite, losses)),
          "host-tier run: %s" % losses)
    rows = _host_rows(ex.host_manager)
    # the HBM tier: its tables hold the host stores' initial rows
    hbm = _host_executor(dzoo_edl, parts[0], device)
    tables = _init_rows(np.arange(HOST_VOCAB, dtype=np.int64))
    hbm.state = hbm.trainer.init_state(None, params=dict(init, **{
        "%s.embedding_table" % n: torch.from_numpy(tables[n])
        for n in HOST_TABLES}))
    check(not hbm.trainer._taps, "the frappe-width tables are tapped")
    _sync(device)
    reset_all_launch_counts()
    hbm_losses = _host_train(hbm, parts)
    _sync(device)
    launches["parity_hbm"] = _host_counts()
    out["losses_host"], out["losses_hbm"] = losses, hbm_losses
    out["host_vs_hbm_loss_max_abs"] = _check_close(
        "host-tier losses against the HBM tier's", losses, hbm_losses)
    for name in HOST_TABLES:
        ids, values = rows[name]
        table = hbm.state.params["%s.embedding_table" % name]
        out["host_vs_hbm_%s_max_abs" % name] = _check_close(
            "%s rows, host tier against HBM tier" % name, values,
            table.detach().cpu().numpy()[ids])
    out["rows_touched"] = int(rows["edl_embedding"][0].size)
    # the same host-tier steps on the CPU
    if device == "cuda":
        cpu = _host_executor(thost, parts[0], "cpu")
        cpu.state = cpu.trainer.init_state(None, params=init)
        cpu_losses = _host_train(cpu, parts)
        out["cuda_vs_cpu_loss_max_abs"] = _check_close(
            "host-tier losses, card against CPU", losses, cpu_losses)
        cpu_rows = _host_rows(cpu.host_manager)
        for name in HOST_TABLES:
            check(np.array_equal(rows[name][0], cpu_rows[name][0]),
                  "the card and the CPU made other %s rows" % name)
            out["cuda_vs_cpu_%s_max_abs" % name] = _check_close(
                "%s rows, card against CPU" % name, rows[name][1],
                cpu_rows[name][1])
        for key, p in ex.state.params.items():
            _check_close("%s, card against CPU" % key,
                         p.detach().cpu().numpy(),
                         cpu.state.params[key].detach().numpy())
    return ex, init, out, launches


def host_resume(parts, reference, init, workdir, device):
    """4 steps with a checkpoint, a fresh executor resumed from it for 4
    more: equal bit for bit to `reference`'s 8 uninterrupted steps."""
    ck = os.path.join(workdir, "host_ckpt")
    first = _host_executor(thost, parts[0], device, checkpoint_dir=ck,
                           checkpoint_steps=HOST_STEPS // 2)
    check(all(torch.equal(p.detach().cpu(), init[k]) for k, p in
              first.trainer.model.state_dict().items()),
          "two executors seeded alike start from other dense weights")
    losses = _host_train(first, parts[:1])
    flat, version = load_checkpoint(ck)
    host_keys = sorted(k for k in flat if k.startswith(".host_embeddings"))
    check(version == HOST_STEPS // 2 and host_keys == sorted(
        first.host_manager.flat_state()),
          "the checkpoint (version %d) holds host leaves %s" % (
              version, host_keys[:4]))
    del first
    second = _host_executor(thost, parts[1], device,
                            checkpoint_dir_for_init=ck)
    _sync(device)
    t0 = time.perf_counter()
    losses += _host_train(second, parts[1:])
    _sync(device)
    out = {"resumed_losses": losses, "checkpoint_version": version,
           "checkpoint_host_leaves": len(host_keys),
           "second_run_s": time.perf_counter() - t0}
    check(losses == reference.losses,
          "resumed losses %s, uninterrupted %s" % (losses, reference.losses))
    for key, p in reference.state.params.items():
        check(torch.equal(second.state.params[key], p),
              "resumed %s differs from the uninterrupted run's" % key)
    want, got = _host_rows(reference.host_manager), _host_rows(
        second.host_manager)
    for name in HOST_TABLES:
        check(np.array_equal(got[name][0], want[name][0])
              and np.array_equal(got[name][1], want[name][1]),
              "resumed %s rows differ from the uninterrupted run's" % name)
        check(second.host_manager.tables()[name].engine.state_dict()[
            "step"] == HOST_STEPS, "%s engine step" % name)
    out["resume_equal"] = "bit for bit: losses, dense parameters, host rows"
    return out


def host_export(executor, workdir, rng, device):
    """Export the trained host-tier model with its rows, serve held-out
    rows from it, hold the predictions to the executor's forward and the
    caller's manager to its bytes."""
    manager = executor.host_manager
    path = os.path.join(workdir, "host_export")
    before = _host_digest(manager)
    t0 = time.perf_counter()
    export_model(executor.trainer.model, executor.state, path,
                 host_manager=manager)
    export_s = time.perf_counter() - t0
    payload, meta = load_exported(path)
    serve = make_serving_fn(executor.trainer.model, payload,
                            host_manager=manager)
    held = {"feature": rng.randint(0, HOST_VOCAB, (HOST_HELD_OUT, 10)
                                   ).astype(np.int32)}
    served = serve(held)
    _sync(device)
    check(_host_digest(manager) == before,
          "make_serving_fn moved the caller's host rows")
    ref = executor.trainer.forward(executor.state, held)
    diff = float((served["logits"] - ref["logits"]).abs().max())
    check(diff == 0.0 and torch.equal(served["probs"], ref["probs"]),
          "served logits differ from the executor's forward by %.3g" % diff)
    return {"export_bytes": os.path.getsize(os.path.join(path,
                                                         "params.msgpack")),
            "export_s": export_s, "export_version": meta["version"],
            "served_rows": HOST_HELD_OUT, "served_vs_forward_max_abs": diff,
            "caller_rows_unchanged": {n: c for n, (c, _h) in before.items()}}


def _scale_steps(trainer, state, batches, device):
    """Each batch one train step, timed on the host clock to a
    synchronized end, with nothing wrapped; (state, losses, ms, unique
    rows a step of the host tier's table, or None)."""
    losses, ms, uniq = [], [], []
    manager = trainer.host_manager
    for batch in batches:
        _sync(device)
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if manager:
            uniq.append(int(manager.tables()["edl_embedding"]
                            .last_unique.size))
    return state, losses, ms, uniq or None


def _step_summary(ms, uniq=None):
    out = {"step_ms": ms, "step_p50_ms": float(np.percentile(ms, 50)),
           "step_p99_ms": float(np.percentile(ms, 99)),
           "samples_per_s": HOST_SCALE_BATCH / (np.percentile(ms, 50)
                                                / 1e3)}
    if uniq:
        out["unique_rows_per_step"] = uniq
        out["unique_rows_mean"] = float(np.mean(uniq))
    return out


def _split_steps(trainer, state, batches, device):
    """The host tier's step split into prepare (unique + native lookup),
    h2d (the prepared features to the device), device (forward and
    backward, to an idle device), d2h (the row gradients to the host)
    and apply (the native rule), in ms a step: steps of their own, whose
    stages are wrapped here with a device synchronization at each edge
    (the steps timed for the ratio run unwrapped)."""
    manager, edges = trainer.host_manager, {}

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(device)
            edges[name] = (t0, time.perf_counter())
            return out
        return run

    def apply(grads, lr_scale=1.0):
        _sync(device)
        t0 = time.perf_counter()
        grads = {k: v.detach().to("cpu") for k, v in grads.items()}
        edges["d2h"] = (t0, time.perf_counter())
        timed("apply", real_apply)(grads, lr_scale=lr_scale)

    real_apply = manager.apply
    manager.prepare = timed("prepare", manager.prepare)
    trainer._features = timed("h2d", trainer._features)
    manager.apply = apply
    split = {k: [] for k in ("prepare", "h2d", "device", "d2h", "apply")}
    try:
        for batch in batches:
            state, _ = trainer.train_step(state, batch)
            for k, (a, b) in edges.items():
                split[k].append((b - a) * 1e3)
            split["device"].append((edges["d2h"][0] - edges["h2d"][1]) * 1e3)
    finally:
        for obj, attr in ((manager, "prepare"), (trainer, "_features"),
                          (manager, "apply")):
            delattr(obj, attr)  # the class's method again
    return state, {k: float(np.percentile(v, 50)) for k, v in split.items()}


@contextlib.contextmanager
def _held_to_plain(errs):
    """Within: every launch of E (through the embedding layer) and of F
    (through sparse_update) that the path makes is held against its
    plain version on the same inputs, F's on clones of its tables taken
    before the launch. E must be equal; F within ROW_TOL_REL per table,
    the rows its ids do not name bit-identical, and the rows they name
    moved. `errs` collects {kernel: [max |err|, ...]}."""
    real = (embedding_layer.embedding_gather,
            embedding_layer.embedding_gather_many, eo.row_update_many)

    def held(name, outs, refs):
        for out, ref in zip(outs, refs):
            errs.setdefault(name, []).append(
                (out - ref).abs().max().item() if out.numel() else 0.0)
            check(torch.equal(out, ref), "%s differs from its plain version "
                  "at %s on the host-embedding path" % (name,
                                                        tuple(out.shape)))

    def gather(table, ids):
        out = real[0](table, ids)
        held("embedding_gather", [out], [eo.embedding_gather_plain(table,
                                                                   ids)])
        return out

    def gather_many(tables, ids):
        outs = real[1](tables, ids)
        held("embedding_gather_many", outs,
             eo.embedding_gather_many_plain(tables, ids))
        return outs

    def row_update_many(rule, groups, ids, grads, hypers):
        plain = [[t.clone() for t in g] for g in groups]
        named = [u[u >= 0].long() for u in ids]
        before = [g[0][u].clone() for g, u in zip(groups, named)]
        real[2](rule, groups, ids, grads, hypers)
        eo.row_update_many_plain(rule, plain, ids, grads, hypers)
        for group, ref, u, rows in zip(groups, plain, named, before):
            untouched = torch.ones(group[0].shape[0], dtype=torch.bool,
                                   device=group[0].device)
            untouched[u] = False
            for x, y in zip(group, ref):
                diff = (x - y).abs()
                err = diff.max().item()
                rel = err / max(y.abs().max().item(), 1e-30)
                errs.setdefault("row_update_many", []).append(err)
                errs.setdefault("row_update_many_rel", []).append(rel)
                check(rel <= ROW_TOL_REL and not bool(diff[untouched].any()),
                      "row_update_many %s at %s on the host-embedding path: "
                      "rel err %.3g against its plain version, or a row it "
                      "was not given moved" % (rule, tuple(x.shape), rel))
                del diff
            moved = int((group[0][u] != rows).any(1).sum())
            errs.setdefault("row_update_many_moved", []).append(
                [moved, int(u.numel()), int(group[0].shape[1])])
            check(moved > u.numel() // 2, "row_update_many moved %d of the "
                  "%d rows it was given" % (moved, u.numel()))
        del plain

    embedding_layer.embedding_gather = gather
    embedding_layer.embedding_gather_many = gather_many
    eo.row_update_many = row_update_many
    try:
        yield errs
    finally:
        (embedding_layer.embedding_gather,
         embedding_layer.embedding_gather_many, eo.row_update_many) = real


def _scale_profile(trainer, state, batches, step_ms, device):
    if device != "cuda":
        return state, {}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
    return state, device_summary(prof.key_averages(), len(batches), step_ms,
                                 top=6)


def _scale_ids(rng):
    """{stream: [steps, batch, 10] ids in [1, HOST_SCALE_IDS)}: the
    uniform stream (timed steps, then the host tier's split steps, one
    checked step, the profiled steps) and the Zipf stream."""
    n = HOST_SCALE_STEPS + HOST_SPLIT_STEPS + 1 + HOST_PROFILE_STEPS
    uniform = rng.randint(1, HOST_SCALE_IDS, (n, HOST_SCALE_BATCH, 10))
    zipf = rng.zipf(HOST_ZIPF_A, (HOST_SCALE_STEPS, HOST_SCALE_BATCH, 10))
    zipf = (zipf - 1) % (HOST_SCALE_IDS - 1) + 1
    return {"uniform": uniform.astype(np.int32),
            "zipf": zipf.astype(np.int32)}


def host_scale(rng, device):
    """The tier's reason to exist: HOST_SCALE_STEPS steps of
    HOST_SCALE_BATCH rows of 10 ids uniform over [1, HOST_SCALE_IDS)
    (no reuse: the host tier's worst case), in the host tier and, on the
    same batches from the same initial weights and rows, in the HBM
    sparse-row tier, both timed unwrapped; the two tiers' losses and row
    updates held to each other, then one step of each with its E and F
    launches held to their plain versions, the host tier's split, a
    profile, and HOST_SCALE_STEPS steps of a Zipf id stream in each."""
    ids = _scale_ids(rng)
    labels = rng.randint(0, 2, (len(ids["uniform"]), HOST_SCALE_BATCH)
                         ).astype(np.int32)
    batches = [({"feature": x}, y) for x, y in zip(ids["uniform"], labels)]
    zipf = [({"feature": x}, y) for x, y in zip(ids["zipf"], labels)]
    n, m = HOST_SCALE_STEPS, HOST_SCALE_STEPS + HOST_SPLIT_STEPS
    timed, split_batches = batches[:n], batches[n:m]
    checked, profiled = batches[m], batches[m + 1:]
    out, launches = {"batch": HOST_SCALE_BATCH, "ids": HOST_SCALE_IDS,
                     "steps": HOST_SCALE_STEPS, "zipf_a": HOST_ZIPF_A}, {}
    errs = {}
    # host tier
    spec = load_model_spec_from_module(thost)
    trainer = Trainer(spec, device=device)
    manager = attach_from_spec(trainer, spec)
    state = trainer.init_state(None)
    init = _dense_sd(trainer.model)
    reset_all_launch_counts()
    state, host_losses, host_ms, uniq = _scale_steps(trainer, state, timed,
                                                     device)
    launches["scale_host"] = _host_counts()
    host_rows = _host_rows(manager)
    store_rows = {name: len(t.engine.param) for name, t in
                  manager.tables().items()}
    dims = {name: t.engine.dim for name, t in manager.tables().items()}
    out["host"] = dict(_step_summary(host_ms, uniq), losses=host_losses,
                       store_rows=store_rows,
                       store_row_bytes={k: store_rows[k] * dims[k] * 4
                                        for k in store_rows})
    check(all(map(math.isfinite, host_losses)), "host scale losses")
    state, out["host"]["split_p50_ms"] = _split_steps(
        trainer, state, split_batches, device)
    with _held_to_plain(errs):
        state, _ = trainer.train_step(state, checked)
    state, prof = _scale_profile(trainer, state, profiled,
                                 out["host"]["step_p50_ms"], device)
    out["host"].update(prof)
    rows_before = len(manager.tables()["edl_embedding"].engine.param)
    reset_all_launch_counts()
    state, _, zipf_ms, zipf_uniq = _scale_steps(trainer, state, zipf,
                                                device)
    launches["scale_host_zipf"] = _host_counts()
    rows_after = len(manager.tables()["edl_embedding"].engine.param)
    out["host_zipf"] = dict(_step_summary(zipf_ms, zipf_uniq),
                            store_rows_after=rows_after,
                            new_rows_per_step=(rows_after - rows_before)
                            / HOST_SCALE_STEPS)
    del trainer, manager, state
    # HBM sparse-row tier: a [HOST_SCALE_IDS, 64] table and its bias on
    # the card, the rows the batches touch set to the host stores' initial
    # rows, the dense tower to the host run's initial weights
    spec = load_model_spec_from_module(dzoo_edl)
    trainer = Trainer(spec, model_params="input_dim=%d" % HOST_SCALE_IDS,
                      device=device)
    check(sorted(trainer._tapped_tables()) == [
        "edl_embedding.embedding_table", "edl_id_bias.embedding_table"],
          "the HBM tables at %d ids are not both tapped" % HOST_SCALE_IDS)
    touched = np.unique(ids["uniform"][:n])
    rows = _init_rows(touched.astype(np.int64))
    at = torch.as_tensor(touched, device=device).long()
    with torch.no_grad():
        for name in HOST_TABLES:
            table = getattr(trainer.model, name).embedding_table
            table.index_copy_(0, at, torch.from_numpy(rows[name]).to(device))
        for key, value in init.items():
            trainer.model.state_dict()[key].copy_(value)
    state = trainer.init_state(None)
    _sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    state, hbm_losses, hbm_ms, _ = _scale_steps(trainer, state, timed,
                                                device)
    launches["scale_hbm"] = _host_counts()
    out["hbm"] = dict(_step_summary(hbm_ms), losses=hbm_losses, table_bytes=sum(
        t.numel() * 4 for t in state.params.values()
        if t.dim() == 2 and t.shape[0] == HOST_SCALE_IDS))
    if device == "cuda":
        out["hbm"]["peak_memory_bytes"] = int(
            torch.cuda.max_memory_allocated())
    out["host_vs_hbm_loss_max_abs"] = _check_close(
        "scale losses, host tier against HBM tier", host_losses, hbm_losses,
        rtol=HOST_SCALE_LOSS_RTOL)
    # each touched row's change over the run, host tier against HBM tier
    out["host_vs_hbm_row_change"] = {}
    for name in HOST_TABLES:
        host_ids, host_values = host_rows[name]
        pos = np.searchsorted(host_ids, touched)
        check(np.array_equal(host_ids[np.minimum(pos, host_ids.size - 1)],
                             touched), "the host store lacks touched %s "
              "rows" % name)
        table = state.params["%s.embedding_table" % name]
        hbm_change = table[at].detach().cpu().numpy() - rows[name]
        host_change = host_values[pos] - rows[name]
        scale = float(np.abs(hbm_change).max())
        rel = float(np.abs(host_change - hbm_change).max()) / max(scale,
                                                                  1e-30)
        moved = int(np.any(hbm_change != 0, axis=1).sum())
        out["host_vs_hbm_row_change"][name] = {
            "rows": int(touched.size), "rows_moved_hbm": moved,
            "max_abs_change": scale, "max_rel_err": rel}
        check(rel <= HOST_SCALE_ROW_CHANGE_TOL_REL
              and moved > touched.size // 2,
              "%s: the HBM tier moved %d of %d touched rows, %.3g apart "
              "from the host tier's change (max %.3g)" % (
                  name, moved, touched.size, rel, scale))
    with _held_to_plain(errs):
        state, _ = trainer.train_step(state, checked)
    out["held_to_plain"] = errs
    check(len(errs.get("embedding_gather", ())) == 2
          and len(errs.get("embedding_gather_many", ())) == 2
          and len(errs.get("row_update_many_moved", ())) == 2,
          "the checked steps' E and F launches: %s" % {
              k: len(v) for k, v in errs.items()})
    state, prof = _scale_profile(trainer, state, profiled,
                                 out["hbm"]["step_p50_ms"], device)
    out["hbm"].update(prof)
    reset_all_launch_counts()
    state, _, zipf_ms, _ = _scale_steps(trainer, state, zipf, device)
    launches["scale_hbm_zipf"] = _host_counts()
    out["hbm_zipf"] = _step_summary(zipf_ms)
    out["host_over_hbm_step_p50"] = (out["host"]["step_p50_ms"]
                                     / out["hbm"]["step_p50_ms"])
    out["host_over_hbm_step_p50_zipf"] = (out["host_zipf"]["step_p50_ms"]
                                          / out["hbm_zipf"]["step_p50_ms"])
    del trainer, state
    return out, launches


def host_embedding_phase(rng, workdir, device="cuda"):
    """Phase 26: the host-DRAM embedding tier and the DeepFM family (see
    the module docstring). Returns the `host_embedding` line and the E
    and F launches of each of its runs."""
    parts = []
    for i in range(2):
        part = os.path.join(workdir, "frappe_%d" % i)
        port_recordio_gen.gen_frappe_like(
            part, num_files=1, records_per_file=HOST_BATCH * HOST_STEPS // 2,
            input_dim=HOST_VOCAB, seed=HOST_SEED + i)
        parts.append(part)
    out = {"model": "deepfm_host_embedding: embedding_dim 64, input_length "
                    "10, fc_unit 64, SGD 0.1; vocab %d, minibatch %d, %d "
                    "steps" % (HOST_VOCAB, HOST_BATCH, HOST_STEPS)}
    executor, init, out["parity"], launches = host_parity(parts, device)
    out["resume"] = host_resume(parts, executor, init, workdir, device)
    out["export"] = host_export(executor, workdir, rng, device)
    del executor
    if device == "cuda":
        torch.cuda.empty_cache()
    out["scale"], scale_launches = host_scale(rng, device)
    launches.update(scale_launches)
    if device == "cuda":
        torch.cuda.empty_cache()
        per_step = 2 * HOST_STEPS  # one gather a table a step
        check(launches["parity_host"]["embedding_gather"] == per_step
              and launches["parity_host"]["row_update_many"] == 0,
              "host-tier run launched %s" % launches["parity_host"])
        check(launches["parity_hbm"]["embedding_gather"] == per_step,
              "HBM-tier run launched %s" % launches["parity_hbm"])
        for run in ("scale_host", "scale_host_zipf"):
            check(launches[run]["embedding_gather"] == 2 * HOST_SCALE_STEPS
                  and launches[run]["row_update_many"] == 0,
                  "host %s run launched %s" % (run, launches[run]))
        for run in ("scale_hbm", "scale_hbm_zipf"):
            check(launches[run]["embedding_gather_many"]
                  == 2 * HOST_SCALE_STEPS
                  and launches[run]["row_update_many"]
                  == 2 * HOST_SCALE_STEPS,
                  "HBM %s run launched %s" % (run, launches[run]))
    out["launches"] = launches
    log("host_embedding: %s" % json.dumps({k: out[k] for k in (
        "parity", "resume", "export")})[:3000])
    return out, launches


# ------------------------------------------------- the replica on the wire

WIRE_STATUS_CALLS = 20  # server_status round trips timed
WIRE_READY_SECS = 300  # the subprocess's start-up bound


def _wire_streams(stub, specs, gate=None, timeout=600):
    """One client thread a request, streaming `specs` over `stub`.
    With `gate` = (admitted, release): thread i waits until `admitted()`
    reached i before it sends, then the last one sets `release`, so the
    requests are admitted in spec order. Returns each stream's tokens,
    done chunk's version and client stamps (send, first chunk, end)."""
    out = [None] * len(specs)

    def run(i, prompt, new):
        try:
            if gate is not None:
                admitted, _release = gate
                deadline = time.monotonic() + timeout
                while admitted() < i and time.monotonic() < deadline:
                    time.sleep(0.0005)
            t_send = time.perf_counter()
            tokens, first, last = [], None, None
            for chunk in stub.generate_stream(
                    wire_pb.GenerateRequest(prompt=prompt,
                                            max_new_tokens=new),
                    timeout=timeout):
                if first is None:
                    first = time.perf_counter()
                tokens.extend(chunk.tokens)
                last = chunk
            out[i] = dict(tokens=tokens, done=last.done,
                          version=last.model_version, t_send=t_send,
                          t_first=first, t_end=time.perf_counter())
        except Exception as e:  # noqa: BLE001 - checked below
            out[i] = e

    threads = [threading.Thread(target=run, args=(i, p, n), daemon=True)
               for i, (p, n) in enumerate(specs)]
    for t in threads:
        t.start()
    if gate is not None:
        admitted, release = gate
        deadline = time.monotonic() + timeout
        while admitted() < len(specs) and time.monotonic() < deadline:
            time.sleep(0.0005)
        release.set()
    for t in threads:
        t.join(timeout=timeout)
        check(not t.is_alive(), "a wire client did not finish")
    for i, r in enumerate(out):
        check(isinstance(r, dict), "wire request %d failed: %r" % (i, r))
        check(r["done"], "wire request %d ended without its done chunk" % i)
    return out


def _wire_entry(specs, ref_streams, device):
    """`python -m elasticdl_tpu_torch.serving.main --port 0` at the
    flagship as a process: seconds to SERVING_READY, one streamed
    request against the in-process tokens, SIGTERM, exit 0."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env.pop("EDL_FAULT_SPEC", None)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "elasticdl_tpu_torch.serving.main",
           "--device", device, "--port", "0", "--model_params",
           _params_str(FLAGSHIP), "--num_slots", "8", "--kv_paged", "1",
           "--kv_block_size", "16"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    ready = threading.Event()

    def read():
        for line in iter(proc.stdout.readline, ""):
            lines.append(line)
            if line.startswith("SERVING_READY"):
                ready.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + WIRE_READY_SECS
        while not ready.wait(0.05):
            check(proc.poll() is None and time.monotonic() < deadline,
                  "the serving entry never printed SERVING_READY (rc %s): %s"
                  % (proc.poll(), "".join(lines)[-3000:]))
        ready_s = time.perf_counter() - t0
        port = int([l for l in lines if l.startswith("SERVING_READY")][0]
                   .split("port=")[1])
        stub = wire_service.ServingStub(wire_service.build_channel(
            "localhost:%d" % port))
        prompt, new = specs[0]
        stream = iter(stub.generate_stream(wire_pb.GenerateRequest(
            prompt=prompt, max_new_tokens=new), timeout=600))
        chunks = [next(stream)]
        proc.send_signal(signal.SIGTERM)  # mid-stream: it must drain
        chunks.extend(stream)
        tokens = [t for c in chunks for t in c.tokens]
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=30)
        proc.stdout.close()
    check(rc == 0, "the serving entry exited %s after SIGTERM: %s"
          % (rc, "".join(lines)[-3000:]))
    check(len(tokens) == new and chunks[-1].done,
          "the entry's stream gave %d of %d tokens" % (len(tokens), new))
    return dict(ready_s=ready_s, rc=rc, tokens=tokens,
                stream_equal=tokens == ref_streams[0])


def serving_wire_phase(specs, ref_streams, inproc_tokens_per_s,
                       device="cuda"):
    """Phase 27: the port's replica on its transport at the flagship
    (paged, block 16, prefix sharing, 8 slots), in this process. (1)
    The 16 requests, one client thread each through
    ServingStub.generate_stream, admitted in spec order while the
    scheduler waits, so each is seated and batched as the in-process
    run's: every stream equal to the in-process run's, A and B launched,
    server_status's counters equal to the run's. (2) The same 16 sent
    together, timed: tokens/s against in-process, client TTFT. (3)
    server_status round trips. (4) The entry as a process. A timed or
    entry stream that leaves the in-process one must leave it at a
    near-tie (near_tie_gaps)."""
    on_card = device == "cuda"
    model = TransformerLM(device=device, seed=0, **FLAGSHIP)
    server = GenerationServer(model, ServingConfig(
        num_slots=8, queue_capacity=64, kv_paged=True, kv_block_size=16,
        kv_shared=True, port=0)).start(transport=True)
    stub = wire_service.ServingStub(wire_service.build_channel(
        "localhost:%d" % server.port))
    out = {"port": server.port}
    try:
        # warm the card outside the counts, as serve_flagship does
        list(stub.generate_stream(wire_pb.GenerateRequest(
            prompt=[1, 2, 3, 4], max_new_tokens=2), timeout=600))
        status0 = stub.server_status(wire_pb.ServerStatusRequest(),
                                     timeout=60)
        # (1) the held pass: the scheduler runs a job that waits until
        # the 16 are admitted
        held, release = threading.Event(), threading.Event()

        def hold_job():
            held.set()
            release.wait(600)

        hold = threading.Thread(target=server.scheduler.submit_job,
                                args=(hold_job, 620), daemon=True)
        hold.start()
        check(held.wait(60), "the scheduler did not take the hold job")
        base = server.telemetry.counters["admitted"]
        _sync(device)
        att.reset_launch_counts()
        held = _wire_streams(stub, specs, gate=(
            lambda: server.telemetry.counters["admitted"] - base, release))
        _sync(device)
        launches = dict(att.KERNEL_LAUNCHES)
        hold.join(timeout=60)
        status1 = stub.server_status(wire_pb.ServerStatusRequest(),
                                     timeout=60)
        streams = [r["tokens"] for r in held]
        for i, (got, ref) in enumerate(zip(streams, ref_streams)):
            check(got == ref, "wire request %d: tokens differ from the "
                  "in-process run's from position %s" % (
                      i, _first_divergence(got, ref)))
        new_total = sum(n for _p, n in specs)
        check(status1.completed - status0.completed == len(specs)
              and status1.tokens_generated - status0.tokens_generated
              == new_total and status1.admitted - status0.admitted
              == len(specs) and status1.rejected == status0.rejected,
              "server_status after the wire run: %r then %r"
              % (status0, status1))
        check(all(r["version"] == 0 for r in held),
              "a done chunk's model_version is not 0")
        if on_card:
            for name in SERVING_KERNELS:
                check(launches[name] > 0, "kernel %s was not launched on "
                      "the wire path" % name)
            every = {n for kv in ("", "int8") for w in (0, 1)
                     for n in serving_kernels(kv, w)}
            for name in every - set(SERVING_KERNELS):
                check(launches[name] == 0, "kernel %s was launched on the "
                      "wire path" % name)
        out["launches"] = {n: launches[n] for n in SERVING_KERNELS}
        out["streams_equal_in_process"] = len(specs)
        out["status"] = {k: getattr(status1, k) for k in (
            "completed", "tokens_generated", "admitted", "rejected",
            "prefix_hit_tokens", "cow_copies", "kv_blocks_total",
            "kv_bytes_total", "max_active_slots", "ttft_p50_ms",
            "ttft_p99_ms", "queue_wait_p50_ms")}
        # (2) the timed pass: 16 clients at once
        _sync(device)
        t0 = time.perf_counter()
        timed = _wire_streams(stub, specs)
        _sync(device)
        wall = time.perf_counter() - t0
        ttft = np.asarray([r["t_first"] - r["t_send"] for r in timed]) * 1e3
        tokens = sum(len(r["tokens"]) for r in timed)
        out["timed"] = {
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "in_process_tokens_per_s": inproc_tokens_per_s,
            "wire_over_in_process": tokens / wall / inproc_tokens_per_s,
            "client_ttft_ms_p50": float(np.percentile(ttft, 50)),
            "client_ttft_ms_p99": float(np.percentile(ttft, 99)),
            "streams_equal_in_process": sum(
                r["tokens"] == ref for r, ref in zip(timed, ref_streams)),
        }
        timed_streams = [r["tokens"] for r in timed]
        # (3) server_status round trips (host counters only)
        rtt = []
        for _ in range(WIRE_STATUS_CALLS):
            t0 = time.perf_counter()
            stub.server_status(wire_pb.ServerStatusRequest(), timeout=60)
            rtt.append((time.perf_counter() - t0) * 1e3)
        out["server_status_ms_p50"] = float(np.percentile(rtt, 50))
        out["server_status_ms_max"] = float(max(rtt))
    finally:
        server.stop(drain=True, timeout=120)
    check(server.scheduler.crashed is None,
          "scheduler crashed: %r" % (server.scheduler.crashed,))
    del server
    # the timed pass seats and batches as the clients arrive: a stream
    # that leaves the in-process one must leave it at a near-tie
    prompts = [p for p, _n in specs]
    out["timed"]["near_tie"] = near_tie_gaps(
        model, prompts, ref_streams, {"timed": timed_streams})["timed"]
    # (4) the entry as a process
    entry = _wire_entry(specs, ref_streams, device)
    if not entry["stream_equal"]:
        # one request alone decodes at batch 1, the in-process run at up
        # to 8: a difference must be a near-tie there
        entry["near_tie"] = near_tie_gaps(
            model, prompts[:1], ref_streams[:1],
            {"entry": [entry["tokens"]]})["entry"]
    del entry["tokens"], model
    if on_card:
        torch.cuda.empty_cache()
    out["entry"] = entry
    log("serving_wire: %s" % json.dumps(out))
    return out, launches


# --------------------------------------- phase 28: the host tier, handoffs

TIERS_SEED = 28
TIERS_PROMPTS = 48  # distinct prompts, each sent in two passes
# 63 full blocks (a full-prompt match re-runs one token), and 62 blocks
# with an 8-token suffix (one tile of 8 rows: B's split kernel)
TIERS_LENS = (1008, 1000)
TIERS_NEW = 16
TIERS_BLOCKS = 512  # the dense-equivalent pool of 8 slots
TIERS_REF_BLOCKS = 3200  # every chain of the 48 resident
TIERS_HOST_BLOCKS = 4096  # 2 GiB of bf16 blocks: every spilled chain
TIERS_SMALL_HOST_BLOCKS = 512  # 256 MiB of bf16 blocks: 8 chains
TIERS_INT8_PROMPTS = 16
TIERS_DISAGG_PROMPTS = 16
# the handoff's prompts: 63 full blocks, and 62 with a 13-token suffix
# (a 16-row tile: B's tile kernel)
TIERS_DISAGG_LENS = (1008, 1005)
TIERS_COLD_PROMPTS = 4  # cold prefills on the decode replica
TIERS_WAIT_S = 600
TIERS_KERNELS = SERVING_KERNELS + SERVING_INT8_KERNELS[1:]


def _tiers_block_bytes(model):
    """One block's bytes in the model's KV format, every layer's leaves:
    what `kv_host_bytes` buys a block of."""
    layers, hkv, d, dtype, kv = kv_layout(model)
    if kv == "int8":
        row = hkv * (d + 4)  # int8 rows and an fp32 scale each
    else:
        row = hkv * d * torch.empty((), dtype=dtype).element_size()
    return layers * 2 * 16 * row


def _tiers_server(model, num_blocks, host_blocks=0, role="unified",
                  profile=False):
    """A paged replica (8 slots, block 16, prefix sharing) with a host
    tier of `host_blocks` of the model's blocks."""
    return GenerationServer(model, ServingConfig(
        num_slots=8, queue_capacity=64, kv_paged=True, kv_block_size=16,
        kv_num_blocks=num_blocks, kv_shared=True,
        kv_host_bytes=host_blocks * _tiers_block_bytes(model), role=role,
        profile=profile, port=0))


def _tiers_guard(server, out):
    """After every scheduler tick: the host tier's bytes, its peak in
    out["host_bytes_peak"], any tick over the budget in out["over"]."""
    sched, kv = server.scheduler, server.engine.kv
    tick = sched._iterate

    def iterate():
        tick()
        used = kv.host_bytes_in_use()
        out["host_bytes_peak"] = max(out.get("host_bytes_peak", 0), used)
        out["ticks"] = out.get("ticks", 0) + 1
        if used > kv.host_bytes_budget:
            out.setdefault("over", []).append(used)

    sched._iterate = iterate


def _tiers_shared_log(engine, log):
    """request_id -> the tokens its seat shared (resident or revived)."""
    seat = engine._seat_blocks

    def logged(slot, request):
        shared = seat(slot, request)
        log[request.request_id] = shared
        return shared

    engine._seat_blocks = logged


def _tiers_pass(server, specs):
    """All of `specs` admitted while the scheduler waits on a held job,
    then released: the seat order and the decode batches are the same in
    every pass and on every replica. Returns the requests and the pass's
    times (TTFT from the release, which includes the queue; seat to
    first token, the prefill or revival itself)."""
    held, release = threading.Event(), threading.Event()

    def hold_job():
        held.set()
        release.wait(TIERS_WAIT_S)

    hold = threading.Thread(target=server.scheduler.submit_job,
                            args=(hold_job, TIERS_WAIT_S + 20), daemon=True)
    hold.start()
    check(held.wait(60), "the scheduler did not take the hold job")
    reqs = [server.submit(p, n) for p, n in specs]
    t0 = time.monotonic()  # the scheduler's clock
    release.set()
    try:
        for req in reqs:
            for _chunk in server.events(req):
                pass
    except Exception as e:  # noqa: BLE001 - surfaced with the cause
        crashed = server.scheduler.crashed
        raise SmokeFailure("a tiers request failed (%r); the scheduler: %s"
                           % (e, "".join(traceback.format_exception(
                               crashed)) if crashed else "running"))
    wall = time.monotonic() - t0
    hold.join(timeout=60)
    for req, (_p, n) in zip(reqs, specs):
        check(len(req.generated) == n, "request %d finished with %d of %d "
              "tokens" % (req.request_id, len(req.generated), n))
    ttft = np.asarray([r.first_token_at - t0 for r in reqs]) * 1e3
    seat = np.asarray([r.first_token_at - r.seated_at for r in reqs]) * 1e3
    return reqs, {
        "wall_s": wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "seat_to_first_ms_p50": float(np.percentile(seat, 50)),
        "seat_to_first_ms_p99": float(np.percentile(seat, 99)),
    }


@contextlib.contextmanager
def _attention_held_to_plain(errs, on_card, where="tiers"):
    """Within: every launch of A (flash_forward) and B
    (paged_decode_partials) is held against its plain version on the
    same inputs, as _held_to_plain holds E and F: A by fwd_ok with out's
    error over max(max |out|, 1) (the model's activations reach several
    units, where one bf16 step of out is 0.03: FLASH_TOL_OUT is set for
    unit-scale inputs; fp32 inputs are held by their relative errors),
    B's partials within PAGED_TOL_REL. `errs`
    collects {kernel: [max |err|, ...]}. Off the card the wrappers are
    the plain versions: no check."""
    real = (att.flash_forward, att.paged_decode_partials)
    if not on_card:
        yield errs
        return

    def fwd(q, k, v, **kw):
        out, lse = real[0](q, k, v, **kw)
        masks = {n: x for n, x in kw.items() if n != "causal"}
        e = flash_fwd_errs(q, k, v, out, lse, kw.get("causal", False),
                           masks)
        errs.setdefault("flash_fwd", []).append(e["max_abs_err"])
        e["out_scale"] = max(out.float().abs().max().item(), 1.0)
        check(fwd_ok(dict(e, max_abs_err=e["max_abs_err"] / e["out_scale"])),
              "flash_fwd differs from its plain version at %s on the %s "
              "path: %s" % (tuple(q.shape), where, e))
        return out, lse

    def paged(qf, k_pool, v_pool, block_table, length, k_scale_pool=None,
              v_scale_pool=None, window=None, t=1):
        args = (qf, k_pool, v_pool, block_table, length, k_scale_pool,
                v_scale_pool)
        got = real[1](*args, window=window, t=t)
        ref = att.paged_decode_partials_plain(*args, window=window, t=t)
        rel = partials_errs(got, ref)
        name = ("paged_decode_tile" if qf.shape[2] > att.SPLIT_MAX_ROWS
                else "paged_decode") + ("_int8" if k_scale_pool is not None
                                        else "")
        errs.setdefault(name, []).append((got[0] - ref[0]).abs().max().item())
        check(all(e <= PAGED_TOL_REL for e in rel), "%s differs from its "
              "plain version at %s on the %s path: %s"
              % (name, tuple(qf.shape), where, rel))
        return got

    att.flash_forward, att.paged_decode_partials = fwd, paged
    try:
        yield errs
    finally:
        att.flash_forward, att.paged_decode_partials = real


def _tiers_counts():
    return {n: att.KERNEL_LAUNCHES[n] for n in TIERS_KERNELS}


def _tiers_delta(before):
    return {n: att.KERNEL_LAUNCHES[n] - before[n] for n in TIERS_KERNELS}


def _tiers_spill_revive(model, specs, ref_streams, errs, launches, on_card):
    """(1) Spill and revive: a 512-block replica with a 4096-block host
    tier, two timed passes of `specs` and a third under the held-to-plain
    check (the revival path again); each pass's streams equal the
    resident reference's of that pass (pass 3: of pass 2)."""
    server = _tiers_server(model, TIERS_BLOCKS, TIERS_HOST_BLOCKS,
                           profile=True)
    guard, shared = {}, {}
    _tiers_guard(server, guard)
    _tiers_shared_log(server.engine, shared)
    server.start()
    out = {}
    try:
        server.generate([1, 2, 3, 4], 2)  # warm, outside the counts
        _sync("cuda" if on_card else "cpu")
        server.engine.profiler = StepProfiler()  # the passes' phases only
        passes = []
        for name in ("pass1", "pass2", "pass3"):
            if name == "pass3":  # the timed passes' profile and economy
                out["profile"] = server.engine.profiler.snapshot()
                out["revived_blocks"] = server.engine.kv.allocator.\
                    blocks_revived
            with _attention_held_to_plain(errs if name == "pass3" else {},
                                          on_card and name == "pass3"):
                before = _tiers_counts()
                reqs, times = _tiers_pass(server, specs)
                _sync("cuda" if on_card else "cpu")
                launches["spill_revive_" + name] = _tiers_delta(before)
            passes.append(reqs)
            out[name] = times
        status = server.status()
        alloc = server.engine.kv.allocator
    finally:
        server.stop(timeout=120)
    check(server.scheduler.crashed is None,
          "scheduler crashed: %r" % (server.scheduler.crashed,))
    for n, (reqs, ref) in enumerate(zip(passes,
                                        ref_streams + ref_streams[1:])):
        for i, (req, want) in enumerate(zip(reqs, ref)):
            check(req.generated == want, "host tier pass %d request %d: "
                  "tokens leave the resident replica's from position %s"
                  % (n + 1, i, _first_divergence(req.generated, want)))
    whole = [shared[r.request_id] == len(r.prompt) // 16 * 16
             for r in passes[1] + passes[2]]
    check(all(whole), "passes 2 and 3 seated %d of %d prompts on their "
          "whole chain" % (sum(whole), len(whole)))
    check(status["host_drops"] == 0 and alloc.spills > 0
          and status["revive_uploads"] > 0,
          "host tier: %d spills, %d revive uploads, %d drops"
          % (alloc.spills, status["revive_uploads"], status["host_drops"]))
    check(status["prefill_tokens_revived"] == alloc.blocks_revived * 16,
          "prefill_tokens_revived %d, revived blocks %d"
          % (status["prefill_tokens_revived"], alloc.blocks_revived))
    check(not guard.get("over"), "the host tier went over its budget after "
          "%d ticks: %s" % (len(guard.get("over", ())), guard.get("over")))
    if on_card:
        p1, p2, p3 = (launches["spill_revive_" + n]
                      for n in ("pass1", "pass2", "pass3"))
        check(p1["flash_fwd"] > 0 and p1["paged_decode"] > 0
              and p2["paged_decode"] > 0 and p2["flash_fwd"] == 0
              and p3 == p2, "spill/revive launches: %s, %s, %s"
              % (p1, p2, p3))
    revive = out["profile"].get("revive_upload", {})
    uploaded = out["revived_blocks"] * _tiers_block_bytes(model)
    out.update(
        streams_equal_resident=len(specs) * 3,
        revived_blocks_all=alloc.blocks_revived,
        spills=alloc.spills, host_drops=status["host_drops"],
        revive_uploads=status["revive_uploads"],
        prefill_tokens_revived=status["prefill_tokens_revived"],
        host_bytes_peak=guard.get("host_bytes_peak", 0),
        host_bytes_budget=status["kv_host_bytes_budget"],
        ticks_checked=guard.get("ticks", 0),
        revive_upload_ms=revive,
        uploaded_bytes=uploaded,
        upload_gb_per_s=(uploaded / (revive["total_ms"] / 1e3) / 1e9
                         if revive.get("total_ms") else None),
    )
    return out


def _tiers_small_host(model, specs, ref_streams, prompts, errs, launches,
                      on_card):
    """(2) A 512-block host tier (8 chains), both passes under the
    held-to-plain check: chains drop, the budget holds, and a pass-2
    prompt seats on what is left of its chain. Whole chains give the
    resident reference's pass-2 stream, dropped ones prefill again and
    give its pass-1 stream; a chain cut short re-runs its dropped tail
    as one tile, whose stream must equal pass 2's or leave it at a
    near-tie (near_tie_gaps)."""
    server = _tiers_server(model, TIERS_BLOCKS, TIERS_SMALL_HOST_BLOCKS)
    guard, shared = {}, {}
    _tiers_guard(server, guard)
    _tiers_shared_log(server.engine, shared)
    server.start()
    try:
        with _attention_held_to_plain(errs, on_card):
            before = _tiers_counts()
            reqs1, _ = _tiers_pass(server, specs)
            reqs2, times = _tiers_pass(server, specs)
            _sync("cuda" if on_card else "cpu")
            launches["small_host"] = _tiers_delta(before)
        status = server.status()
    finally:
        server.stop(timeout=120)
    check(server.scheduler.crashed is None,
          "scheduler crashed: %r" % (server.scheduler.crashed,))
    for i, (req, want) in enumerate(zip(reqs1, ref_streams[0])):
        check(req.generated == want, "small host tier pass 1 request %d: "
              "tokens leave the resident replica's" % i)
    kinds = {"whole": 0, "dropped": 0, "cut": 0}
    cut_streams, cut_refs, cut_prompts = [], [], []
    for i, req in enumerate(reqs2):
        full = len(req.prompt) // 16 * 16
        got = shared[req.request_id]
        if got == full:
            kinds["whole"] += 1
            want = ref_streams[1][i]
        elif got == 0:
            kinds["dropped"] += 1
            want = ref_streams[0][i]
        else:
            kinds["cut"] += 1
            cut_streams.append(req.generated)
            cut_refs.append(ref_streams[1][i])
            cut_prompts.append(prompts[i])
            continue
        check(req.generated == want, "small host tier pass 2 request %d "
              "(shared %d of %d): tokens leave the reference's" % (
                  i, got, full))
    near = near_tie_gaps(model, cut_prompts, cut_refs,
                         {"cut": cut_streams})["cut"] if cut_streams else None
    check(status["host_drops"] > 0 and not guard.get("over"),
          "small host tier: %d drops, over the budget at %s"
          % (status["host_drops"], guard.get("over")))
    return dict(
        times_pass2=times, seats=kinds, cut_near_tie=near,
        host_drops=status["host_drops"],
        revive_uploads=status["revive_uploads"],
        host_bytes_peak=guard.get("host_bytes_peak", 0),
        host_bytes_budget=status["kv_host_bytes_budget"],
        ticks_checked=guard.get("ticks", 0))


def _rows_digest(rows):
    h = hashlib.sha256()
    for r in rows:
        h.update(r.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _tiers_int8(specs, errs, launches, on_card, device):
    """(3) int8 arenas: every block revived is read back and its rows and
    scales hashed against what the spill read before eviction."""
    model = TransformerLM(device=device, seed=0, kv_cache_dtype="int8",
                          **FLAGSHIP)
    server = _tiers_server(model, TIERS_BLOCKS, TIERS_HOST_BLOCKS)
    kv = server.engine.kv
    alloc = kv.allocator
    spilled, compared = {}, []
    sink = alloc._spill_sink

    def spill(bid, vid):
        sink(bid, vid)
        spilled[vid] = _rows_digest(kv._host_rows[vid])

    apply = kv._apply_revivals

    def revive():
        moves = list(alloc._revived)
        apply()
        for vid, bid in moves:
            compared.append(_rows_digest(kv._gather_rows(bid))
                            == spilled[vid])

    alloc._spill_sink, kv._apply_revivals = spill, revive
    server.start()
    try:
        with _attention_held_to_plain(errs, on_card):
            before = _tiers_counts()
            for _ in range(2):
                _tiers_pass(server, specs)
            _sync(device)
            launches["int8"] = _tiers_delta(before)
        status = server.status()
    finally:
        server.stop(timeout=120)
        del model
    check(server.scheduler.crashed is None,
          "scheduler crashed: %r" % (server.scheduler.crashed,))
    check(compared and all(compared), "int8: %d of %d revived blocks "
          "byte-equal to their spilled rows" % (sum(compared),
                                                len(compared)))
    if on_card:
        check(launches["int8"]["paged_decode_int8"] > 0
              and launches["int8"]["paged_decode"] == 0,
              "int8 launches: %s" % launches["int8"])
    return dict(blocks_compared=len(compared), spills=alloc.spills,
                revive_uploads=status["revive_uploads"],
                block_bytes=kv.block_bytes)


class _TimedStub(object):
    """A ServingStub whose calls' wall ms are kept by method."""

    def __init__(self, stub, ms):
        self._stub, self._ms = stub, ms

    def __getattr__(self, name):
        call = getattr(self._stub, name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return call(*args, **kw)
            finally:
                self._ms.setdefault(name, []).append(
                    (time.perf_counter() - t0) * 1e3)

        return timed


class _TiersRep(object):
    def __init__(self, server, ms):
        self.server = server
        self.address = "localhost:%d" % server.port
        self.stub = _TimedStub(wire_service.ServingStub(
            wire_service.build_channel(self.address)), ms)


def _timed_method(obj, name, ms):
    real = getattr(obj, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return real(*args, **kw)
        finally:
            ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

    setattr(obj, name, timed)


def _stream(stub, prompt, new):
    t_send, first, tokens = time.perf_counter(), None, []
    for chunk in stub.generate_stream(wire_pb.GenerateRequest(
            prompt=prompt, max_new_tokens=new), timeout=TIERS_WAIT_S):
        if first is None:
            first = time.perf_counter()
        tokens.extend(chunk.tokens)
    return tokens, (first - t_send) * 1e3


def _tiers_disagg(model, rs, errs, launches, on_card):
    """(4) A prefill replica and a decode replica on the transport; for
    each prompt a HandoffCoordinator exports from the one and imports
    into the other, then the client streams from the decode replica: the
    stream must equal a unified replica's after its own prefill-only
    warm-up. The decode replica runs no A (each full block arrives
    imported; a suffix is a B tile). The first half of the prompts run
    under the held-to-plain check, the second half give the handoff's
    TTFT; cold prompts on the decode replica give a prefill's."""
    vocab = FLAGSHIP["vocab_size"]
    specs = [rs.randint(0, vocab, size=TIERS_DISAGG_LENS[i % 2]).tolist()
             for i in range(TIERS_DISAGG_PROMPTS)]
    cold = [rs.randint(0, vocab, size=TIERS_DISAGG_LENS[0]).tolist()
            for _ in range(TIERS_COLD_PROMPTS)]
    servers = {role: _tiers_server(model, TIERS_BLOCKS, role=role).start(
        transport=True) for role in ("prefill", "decode", "unified")}
    client_ms, pool_ms = {}, {}
    reps = {role: _TiersRep(s, client_ms if role != "unified" else {})
            for role, s in servers.items()}
    _timed_method(servers["prefill"].engine.kv, "export_chain", pool_ms)
    _timed_method(servers["decode"].engine.kv, "import_chain", pool_ms)
    co = HandoffCoordinator(timeout_secs=TIERS_WAIT_S)
    out = {"chain_bytes": [], "handoff_ttft_ms": [], "cold_ttft_ms": []}
    dec_launches = dict.fromkeys(TIERS_KERNELS, 0)
    try:
        before_all = _tiers_counts()
        for i, prompt in enumerate(specs):
            checked = i < len(specs) // 2
            with _attention_held_to_plain(errs if checked else {},
                                          on_card and checked):
                payload = co.export_chain(
                    reps["prefill"], wire_pb.GenerateRequest(prompt=prompt),
                    co.new_transfer_id())
                out["chain_bytes"].append(sum(
                    len(leaf) for blk in payload.blocks
                    for leaf in blk.leaves))
                resp = co.import_chain(reps["decode"], payload)
                check(resp.ok and resp.blocks == len(prompt) // 16,
                      "import covered %d of %d blocks"
                      % (resp.blocks, len(prompt) // 16))
                before = _tiers_counts()
                got, ttft = _stream(reps["decode"].stub, prompt, TIERS_NEW)
                _sync("cuda" if on_card else "cpu")
                for n, c in _tiers_delta(before).items():
                    dec_launches[n] += c
                if not checked:
                    out["handoff_ttft_ms"].append(ttft)
                reps["unified"].stub.generate(wire_pb.GenerateRequest(
                    prompt=prompt, max_new_tokens=1, prefill_only=True),
                    timeout=TIERS_WAIT_S)
                want, _ = _stream(reps["unified"].stub, prompt, TIERS_NEW)
                check(got == want, "handoff: the decode replica's stream "
                      "leaves the unified replica's from position %s"
                      % _first_divergence(got, want))
        launches["disagg_all"] = _tiers_delta(before_all)
        launches["disagg_decode"] = dec_launches
        for prompt in cold:
            _tokens, ttft = _stream(reps["decode"].stub, prompt, TIERS_NEW)
            out["cold_ttft_ms"].append(ttft)
        co.abort_transfer(reps["prefill"], "xfer-aborted")
        wrong = wire_pb.TransferChainRequest.FromString(
            payload.SerializeToString())
        wrong.block_size = 32
        bad = reps["decode"].stub.transfer_chain(wrong, timeout=TIERS_WAIT_S)
        status = {role: reps[role].stub.server_status(
            wire_pb.ServerStatusRequest(), timeout=60)
            for role in ("prefill", "decode")}
    finally:
        for s in servers.values():
            s.stop(timeout=120)
    for s in servers.values():
        check(s.scheduler.crashed is None,
              "scheduler crashed: %r" % (s.scheduler.crashed,))
    pre, dec = status["prefill"], status["decode"]
    imported = sum(len(p) // 16 * 16 for p in specs)
    check(pre.role == "prefill" and dec.role == "decode"
          and pre.chain_exports == len(specs)
          and dec.chain_imports == len(specs)
          and dec.chain_import_tokens == imported
          and pre.transfers_inflight == dec.transfers_inflight == 0
          and pre.transfer_aborts == 1,
          "handoff status: prefill %r, decode %r" % (pre, dec))
    check(not bad.ok and "block_size" in bad.error,
          "a payload of the wrong block size was not refused: %r" % bad)
    if on_card:
        check(dec_launches["flash_fwd"] == 0
              and dec_launches["paged_decode_tile"]
              == FLAGSHIP["num_layers"] * (len(specs) // 2)
              and dec_launches["paged_decode"] > 0,
              "the decode replica's launches after handoffs: %s"
              % dec_launches)
    chain_b = np.asarray(out["chain_bytes"], np.float64)
    exp_ms = np.asarray(client_ms["export_chain"])
    imp_ms = np.asarray(client_ms["transfer_chain"])
    out.update(
        prompts=len(specs), streams_equal_unified=len(specs),
        chain_bytes_p50=float(np.percentile(chain_b, 50)),
        export_rpc_ms_p50=float(np.percentile(exp_ms, 50)),
        export_gather_ms_p50=float(np.percentile(pool_ms["export_chain"],
                                                 50)),
        transfer_rpc_ms_p50=float(np.percentile(imp_ms, 50)),
        import_upload_ms_p50=float(np.percentile(pool_ms["import_chain"],
                                                 50)),
        prefill_only_rpc_ms_p50=float(np.percentile(client_ms["generate"],
                                                    50)),
        handoff_mb_per_s=float(np.sum(chain_b) / 1e6
                               / ((exp_ms.sum() + imp_ms.sum()) / 1e3)),
        handoff_ttft_ms_p50=float(np.percentile(out["handoff_ttft_ms"], 50)),
        cold_ttft_ms_p50=float(np.percentile(out["cold_ttft_ms"], 50)),
        status={role: {k: getattr(st, k) for k in (
            "role", "chain_exports", "chain_imports", "chain_import_tokens",
            "transfer_aborts", "transfers_inflight")}
            for role, st in status.items()},
        wrong_block_size_refused=True)
    out.pop("chain_bytes")
    return out


def _tiers_entry(model, device):
    """(5) serving/main.py's own parser and build_server take
    --kv_host_bytes and --role, and both reach ServerStatus."""
    host = TIERS_HOST_BLOCKS * _tiers_block_bytes(model)
    args = serving_main.parse_serving_args([
        "--device", device, "--port", "0", "--model_params",
        _params_str(FLAGSHIP), "--num_slots", "8", "--kv_paged", "1",
        "--kv_block_size", "16", "--kv_host_bytes", str(host),
        "--role", "decode"])
    server = serving_main.build_server(args)
    st = server.raw_servicer.server_status(wire_pb.ServerStatusRequest())
    budget = server.status()["kv_host_bytes_budget"]
    del server
    check(st.role == "decode" and budget == host and st.kv_host_bytes == 0,
          "the entry's --role / --kv_host_bytes: role %r, budget %d"
          % (st.role, budget))
    return {"role": st.role, "kv_host_bytes_budget": budget}


def serving_tiers_phase(device="cuda"):
    """Phase 28: the paged pool's host spill tier and the disaggregated
    prefill/decode handoff at the flagship (bf16, seeded weights, 8
    slots, block 16, prefix sharing). Its own generator (TIERS_SEED)."""
    on_card = device == "cuda"
    rs = np.random.RandomState(TIERS_SEED)
    vocab = FLAGSHIP["vocab_size"]
    specs = [(rs.randint(0, vocab, size=TIERS_LENS[i % 2]).tolist(),
              TIERS_NEW) for i in range(TIERS_PROMPTS)]
    prompts = [p for p, _n in specs]
    model = TransformerLM(device=device, seed=0, **FLAGSHIP)
    out, errs, launches = {}, {}, {}
    # the reference: a pool that keeps every chain resident
    ref = _tiers_server(model, TIERS_REF_BLOCKS)
    ref.start()
    try:
        ref.generate([1, 2, 3, 4], 2)
        ref_streams, ref_times = [], []
        for _ in range(2):
            reqs, times = _tiers_pass(ref, specs)
            ref_streams.append([list(r.generated) for r in reqs])
            ref_times.append(times)
        ref_status = ref.status()
    finally:
        ref.stop(timeout=120)
    check(ref_status["kv_host_blocks"] == 0 and ref_status[
        "prefix_hit_tokens"] == sum(len(p) // 16 * 16 for p in prompts),
          "the reference did not keep every chain resident: %r" % ref_status)
    out["resident"] = {"pass1": ref_times[0], "pass2": ref_times[1]}
    out["spill_revive"] = _tiers_spill_revive(model, specs, ref_streams,
                                              errs, launches, on_card)
    out["small_host"] = _tiers_small_host(model, specs, ref_streams,
                                          prompts, errs, launches, on_card)
    out["int8"] = _tiers_int8(specs[:TIERS_INT8_PROMPTS], errs, launches,
                              on_card, device)
    if on_card:
        torch.cuda.empty_cache()
    out["disagg"] = _tiers_disagg(model, rs, errs, launches, on_card)
    out["entry"] = _tiers_entry(model, device)
    out["ttft_pass2_over_pass1_p50"] = (
        out["spill_revive"]["pass2"]["seat_to_first_ms_p50"]
        / out["spill_revive"]["pass1"]["seat_to_first_ms_p50"])
    out["ttft_pass2_over_resident_p50"] = (
        out["spill_revive"]["pass2"]["seat_to_first_ms_p50"]
        / out["resident"]["pass2"]["seat_to_first_ms_p50"])
    out["launches"] = launches
    out["held_to_plain"] = {k: {"launches": len(v), "max_abs_err": max(v)}
                            for k, v in errs.items()}
    del model
    if on_card:
        torch.cuda.empty_cache()
    log("serving_tiers: %s" % json.dumps(out))
    return out, launches, errs


# ------------------------------------------ phase 29: the serving router

ROUTER_SEED = 29
ROUTER_PREFIX_LEN = 512  # the shared prefix: 32 blocks
ROUTER_SUFFIX_LEN = 96  # each shared-prefix request's own suffix
# prompt + new tokens fit the flagship's seq_len (1024): a 1000-token
# prompt leaves room for 24, so the distinct prompts are 992 tokens (62
# blocks) and the death drill's 896 (56 blocks, 128 new)
ROUTER_DISTINCT_LEN = 992
ROUTER_SHARED, ROUTER_DISTINCT = 16, 8  # the parity run's requests
ROUTER_NEW = 32
ROUTER_CONCURRENCY = 8
ROUTER_OVERHEAD = 16  # requests of one overhead pass (8 shared, 8 not)
# the passes, interleaved so that drift falls on both sides; each pass
# draws fresh prompts, so none finds another's prefix in R1's cache
ROUTER_OVERHEAD_ORDER = ("direct", "router", "router", "direct", "direct",
                         "router")
ROUTER_STATUS_CALLS = 20  # router_status round trips timed
ROUTER_KILL_STREAMS = 16
ROUTER_KILL_LEN = 896
ROUTER_KILL_NEW = 128
ROUTER_AFTER_KILL = 8
ROUTER_HANDOFF_PROMPTS = 8
ROUTER_HANDOFF_LEN = 1008  # 63 full blocks
ROUTER_HANDOFF_NEW = 16  # 1008 + 16 = seq_len, as phase 28
ROUTER_BLOCKS = 512  # the dense-equivalent pool of 8 slots
# router_main's defaults, which the phase's routers run with
ROUTER_POLL_S, ROUTER_LEASE_S, ROUTER_DISPATCH_S = 0.5, 2.5, 120.0
ROUTER_SETTLE_S = 0.3  # R3 seated nothing new: its slots are full
ROUTER_WAIT_S = 600
ROUTER_KERNELS = SERVING_KERNELS


class _ScheduleLog(object):
    """One replica's engine operations in order, enough to replay its
    computation exactly: each seat (engine.insert) with the request's
    trace id, prompt and sampling, and each decode step (engine.step).
    The trace id rides from the servicer's admission to the queued
    request on the admitting thread. `sink` is a list (a replica in this
    process) or a path (a replica process: one JSON line an operation,
    flushed as written, so a SIGKILL loses none)."""

    def __init__(self, server, sink):
        self._list = sink if isinstance(sink, list) else None
        self._file = (None if self._list is not None
                      else open(sink, "a", buffering=1))
        local = threading.local()
        servicer, queue, engine = (server.raw_servicer, server.queue,
                                   server.engine)
        admit, submit = servicer._admit, queue.submit
        insert, step = engine.insert, engine.step

        def admit_traced(proto_req, context):
            local.trace = proto_req.trace_id
            try:
                return admit(proto_req, context)
            finally:
                local.trace = ""

        def submit_traced(req):
            req.trace_id = getattr(local, "trace", "")
            return submit(req)

        def insert_logged(req):
            self._write(["insert", req.trace_id, req.prompt,
                         req.max_new_tokens, req.temperature, req.seed,
                         req.prefill_only])
            return insert(req)

        def step_logged():
            self._write(["step"])
            return step()

        servicer._admit, queue.submit = admit_traced, submit_traced
        engine.insert, engine.step = insert_logged, step_logged

    def _write(self, entry):
        if self._list is not None:
            self._list.append(entry)
        else:
            self._file.write(json.dumps(entry) + "\n")


def _read_schedule(path):
    """A replica process's logged operations; a last line cut by the
    SIGKILL is dropped."""
    entries = []
    with open(path) as f:
        for line in f:
            try:
                entries.append(json.loads(line))
            except ValueError:
                break
    return entries


def router_replica_main(log_path, argv):
    """Replica R3 of phase 29 (`chip_smoke.py --router-replica LOG
    <serving.main flags>`): the serving entry's own main() over argv,
    with its engine operations logged to LOG (_ScheduleLog), so that the
    phase can replay what this process computed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = serving_main.build_server

    def logged(args):
        server = build(args)
        _ScheduleLog(server, log_path)
        return server

    serving_main.build_server = logged
    return serving_main.main(argv)


def _router_replay(model, entries, errs, held, on_card, reseat=False):
    """Re-run a replica's logged operations on a fresh replica's engine
    (the same configuration and weights): the same seats and batches,
    so the same computation. The first `held` operations run with every
    A and B launch held to its plain version. Returns {trace id: the
    generated tokens} ({trace id: [the tokens of each seat]} with
    `reseat`, where a rerouted request is seated again under its trace)
    and the replay's launches."""
    from elasticdl_tpu_torch.serving.admission import ServingRequest

    engine = _tiers_server(model, ROUTER_BLOCKS).engine
    reqs = {}

    def run(part):
        for entry in part:
            if entry[0] == "step":
                engine.step()
                continue
            _op, trace, prompt, new, temp, seed, prefill_only = entry
            key = (trace, sum(k[0] == trace for k in reqs))
            check(reseat or key[1] == 0, "trace %s seated twice" % trace)
            reqs[key] = ServingRequest(prompt, new, temperature=temp,
                                       seed=seed, prefill_only=prefill_only)
            engine.insert(reqs[key])

    before = _tiers_counts()
    with _attention_held_to_plain(errs, on_card, where="router"):
        run(entries[:held])
    run(entries[held:])
    _sync("cuda" if on_card else "cpu")
    launches = _tiers_delta(before)
    del engine
    if reseat:
        out = {}
        for (trace, _n), r in sorted(reqs.items()):
            out.setdefault(trace, []).append(list(r.generated))
        return out, launches
    return {t: list(r.generated) for (t, _n), r in reqs.items()}, launches


class _Child(object):
    """A child process of the phase whose output lines are collected."""

    def __init__(self, argv, what, fault="", extra_env=None):
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env.pop("EDL_FAULT_SPEC", None)
        if fault:
            env["EDL_FAULT_SPEC"] = fault
        env.update(extra_env or {})
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (repo, env.get("PYTHONPATH")) if p)
        self.what, self.lines, self.stamps = what, [], []
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(argv, cwd=repo, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        self.port = self.ready_s = None

    def _read(self):
        for line in iter(self.proc.stdout.readline, ""):
            self.stamps.append(time.perf_counter())
            self.lines.append(line)

    def tail(self):
        return "".join(self.lines)[-3000:]

    def line(self, prefix):
        """Wait for the first line starting with `prefix`; returns it."""
        deadline = time.monotonic() + WIRE_READY_SECS
        while True:
            hit = [i for i, l in enumerate(list(self.lines))
                   if l.startswith(prefix)]
            if hit:
                # from the spawn to the line's arrival (a child started
                # early was ready long before it was asked)
                self.ready_s = self.stamps[hit[0]] - self.t0
                return self.lines[hit[0]]
            check(self.proc.poll() is None and time.monotonic() < deadline,
                  "%s never printed %s (rc %s): %s" % (
                      self.what, prefix, self.proc.poll(), self.tail()))
            time.sleep(0.005)

    def ready(self, prefix):
        """Wait for the `prefix ... port=N` line; returns N."""
        line = self.line(prefix)
        # the digits only: another thread's log line may land after them
        self.port = int(re.match(r"\d+", line.split("port=")[1]).group())
        return self.port

    def alive(self):
        check(self.proc.poll() is None, "%s died unasked (rc %s): %s"
              % (self.what, self.proc.poll(), self.tail()))

    def stop(self):
        """SIGTERM; the process must exit 0."""
        self.alive()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            rc = "hung"
        check(rc == 0, "%s exited %s after SIGTERM: %s"
              % (self.what, rc, self.tail()))

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._reader.join(timeout=30)
        self.proc.stdout.close()


def _router_child(addrs, what, fault=""):
    argv = [sys.executable, "-m", "elasticdl_tpu_torch.serving.router_main",
            "--port", "0"]
    for addr in addrs:
        argv += ["--replica", addr]
    child = _Child(argv, what, fault)
    child.ready("ROUTER_READY")
    return child


def _routed(stub, method, trace, prompt, new, out=None, deadline_ms=0):
    """One call carrying `trace` as its trace id, into `out`: the new
    tokens, done, the failure's status (None) and details, the chunk
    count and the client stamps (send, first token, end)."""
    out = {} if out is None else out
    out.update(trace=trace, tokens=[], done=False, code=None, chunks=0,
               t_send=time.perf_counter())
    req = wire_pb.GenerateRequest(prompt=prompt, max_new_tokens=new,
                                  trace_id=trace, deadline_ms=deadline_ms)
    try:
        if method.endswith("_stream"):
            for chunk in getattr(stub, method)(req, timeout=ROUTER_WAIT_S):
                if not out["chunks"]:
                    out["t_first"] = time.perf_counter()
                out["chunks"] += 1
                out["tokens"].extend(chunk.tokens)
                out["done"] = chunk.done
        else:
            resp = getattr(stub, method)(req, timeout=ROUTER_WAIT_S)
            out["t_first"] = time.perf_counter()
            out["tokens"] = list(resp.tokens)[len(prompt):]
            out["done"] = True
    except wire_service.RpcError as e:
        out["code"], out["details"] = e.code(), e.details()
    out["t_end"] = time.perf_counter()
    return out


def _pool(calls, workers):
    """Each call on a pool of `workers` client threads; the results in
    order, each bounded by ROUTER_WAIT_S."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        futs = [ex.submit(c) for c in calls]
        return [f.result(timeout=ROUTER_WAIT_S) for f in futs]


def _all_ok(results, new, what):
    for r in results:
        check(r["code"] is None and r["done"] and len(r["tokens"]) == new,
              "%s: %s ended with %s after %d tokens (%s)" % (
                  what, r["trace"], r["code"], len(r["tokens"]),
                  r.get("details", "")))


def _interleave(shared, distinct):
    """Two shared-prefix prompts, then one distinct, and so on."""
    out, shared, distinct = [], list(shared), list(distinct)
    while shared or distinct:
        out += shared[:2] + distinct[:1]
        shared, distinct = shared[2:], distinct[1:]
    return out


def _router_prompts(rs, n_shared, n_distinct):
    vocab = FLAGSHIP["vocab_size"]
    prefix = rs.randint(0, vocab, size=ROUTER_PREFIX_LEN).tolist()
    return _interleave(
        [prefix + rs.randint(0, vocab, size=ROUTER_SUFFIX_LEN).tolist()
         for _ in range(n_shared)],
        [rs.randint(0, vocab, size=ROUTER_DISTINCT_LEN).tolist()
         for _ in range(n_distinct)])


def _wait_polled(stub, n, what, roles=None):
    """Until router_status shows `n` healthy replicas, each polled once
    (free blocks reported) and, with `roles`, advertising them."""
    deadline = time.monotonic() + 60
    while True:
        st = stub.router_status(wire_pb.RouterStatusRequest(), timeout=60)
        polled = all(r.kv_blocks_free > 0 for r in st.replica)
        if roles is not None:
            polled = polled and {r.address: r.role
                                 for r in st.replica} == roles
        if st.healthy == n and polled:
            return st
        check(time.monotonic() < deadline, "%s: the router never showed "
              "%d polled replicas: %r" % (what, n, st))
        time.sleep(0.05)


def _router_status_step(router, direct, addrs):
    """(5) In a quiet fleet: router_status's fleet TTFT percentiles equal
    those of the replicas' own ttft_hist buckets summed here, every
    ReplicaStatus names its replica's address, role, breaker and KV
    counters, and the SLO block holds the three objectives."""
    time.sleep(2 * ROUTER_POLL_S + 0.2)
    for _ in range(10):
        own = {n: s.server_status(wire_pb.ServerStatusRequest(), timeout=60)
               for n, s in direct.items()}
        st = router.router_status(wire_pb.RouterStatusRequest(), timeout=60)
        fleet = LogLinearHistogram()
        for s in own.values():
            fleet.merge(LogLinearHistogram.from_counts(s.ttft_hist))
        want = [fleet.percentile(q) for q in (50, 90, 99)]
        got = [st.ttft_p50_ms, st.ttft_p90_ms, st.ttft_p99_ms]
        if got == want:
            break
        time.sleep(ROUTER_POLL_S)
    check(got == want, "router_status fleet TTFT %s, the replicas' summed "
          "buckets give %s" % (got, want))
    check([s.name for s in st.slo] == ["ttft_p99", "e2e_p99", "goodput"],
          "router_status slo block: %r" % (list(st.slo),))
    by_addr = {r.address: r for r in st.replica}
    for name, s in own.items():
        r = by_addr.get(addrs[name])
        check(r is not None and r.role == s.role == "unified"
              and r.breaker == "closed" and r.healthy
              and (r.kv_blocks_free, r.kv_blocks_cached, r.kv_blocks_shared)
              == (s.kv_blocks_free, s.kv_blocks_cached, s.kv_blocks_shared),
              "ReplicaStatus of %s: %r against its status %r" % (
                  name, r, s))
    return st, own, dict(zip(("p50", "p90", "p99"), got))


def _overhead_pass(stub, method, label, prompts):
    """(2) One pass of `prompts` at ROUTER_CONCURRENCY: its results and
    wall, tokens/s, client TTFT."""
    t0 = time.perf_counter()
    res = _pool([lambda i=i, p=p: _routed(stub, method, "%s-%02d" % (
        label, i), p, ROUTER_NEW) for i, p in enumerate(prompts)],
        ROUTER_CONCURRENCY)
    wall = time.perf_counter() - t0
    _all_ok(res, ROUTER_NEW, label)
    ttft = [(r["t_first"] - r["t_send"]) * 1e3 for r in res]
    return res, ttft, {
        "wall_s": wall,
        "tokens_per_s": sum(len(r["tokens"]) for r in res) / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
    }


def _r3_seated(f, seen):
    """Add to `seen` the step-3 traces that R3's schedule log (open as
    `f`, read on from where the last call stopped) shows seated."""
    while True:
        pos = f.tell()
        line = f.readline()
        if not line.endswith(b"\n"):  # R3 is still writing it
            f.seek(pos)
            return seen
        e = json.loads(line)
        if e[0] == "insert" and e[1].startswith("s3-"):
            seen.add(e[1])


def _death_step(router, r3, r3_log, rs, addrs):
    """(3) ROUTER_KILL_STREAMS streams at once; SIGKILL R3 once every
    one has its first chunk, or once every stream R3 seated has its
    first chunk and R3 has seated no other for ROUTER_SETTLE_S: the
    router may send R3 more streams than its slots, and one waiting for
    a slot gets its first chunk only after a seated one ended. A stream
    R3 admitted but never seated is re-dispatched whole. Each stream
    completes or ends UNAVAILABLE after its chunks, within the dispatch
    timeout; router_status shows 2 healthy within lease + 2 polls;
    ROUTER_AFTER_KILL more requests complete with nothing shed."""
    vocab = FLAGSHIP["vocab_size"]
    prompts = [rs.randint(0, vocab, size=ROUTER_KILL_LEN).tolist()
               for _ in range(ROUTER_KILL_STREAMS)]
    outs = [{} for _ in prompts]
    threads = [threading.Thread(target=_routed, daemon=True, args=(
        router, "router_generate_stream", "s3-%02d" % i, p, ROUTER_KILL_NEW,
        outs[i])) for i, p in enumerate(prompts)]
    seated, settled_since = set(), time.monotonic()
    with open(r3_log, "rb") as f:
        f.seek(0, os.SEEK_END)
        for t in threads:
            t.start()
        deadline = time.monotonic() + ROUTER_WAIT_S
        while not all("t_first" in o or o.get("code") for o in outs):
            check(time.monotonic() < deadline, "the death streams never "
                  "all delivered a first chunk")
            n = len(seated)
            now = time.monotonic()
            if len(_r3_seated(f, seated)) > n:
                settled_since = now
            first = {o["trace"] for o in outs if "t_first" in o}
            if (seated and seated <= first
                    and now - settled_since >= ROUTER_SETTLE_S):
                break
            time.sleep(0.001)
    all_first = all("t_first" in o or o.get("code") for o in outs)
    r3.alive()
    t_kill = time.monotonic()
    r3.proc.kill()
    r3.proc.wait()
    while True:
        st = router.router_status(wire_pb.RouterStatusRequest(), timeout=60)
        if st.healthy == 2:
            evict_s = time.monotonic() - t_kill
            break
        check(time.monotonic() - t_kill < 60, "R3 never left the rotation: "
              "%r" % st)
        time.sleep(0.01)
    check(evict_s <= ROUTER_LEASE_S + 2 * ROUTER_POLL_S,
          "R3 left the rotation %.2f s after its SIGKILL (bound %.2f s)"
          % (evict_s, ROUTER_LEASE_S + 2 * ROUTER_POLL_S))
    for t in threads:
        t.join(timeout=ROUTER_DISPATCH_S + 30)
        check(not t.is_alive(), "a death stream hangs")
    failed = []
    for o in outs:
        check(o["t_end"] - o["t_send"] < ROUTER_DISPATCH_S,
              "stream %s took %.1f s" % (o["trace"], o["t_end"] - o["t_send"]))
        if o["code"] is None:
            check(o["done"] and len(o["tokens"]) == ROUTER_KILL_NEW,
                  "stream %s ended without an error after %d tokens"
                  % (o["trace"], len(o["tokens"])))
        else:
            check(o["code"] == "UNAVAILABLE" and o["chunks"] >= 1
                  and "mid-stream" in o["details"],
                  "stream %s failed %s after %d chunks: %s" % (
                      o["trace"], o["code"], o["chunks"], o["details"]))
            failed.append(o["trace"])
    after = _pool([lambda i=i, p=p: _routed(
        router, "router_generate_stream", "s3b-%02d" % i, p, ROUTER_NEW)
        for i, p in enumerate(
            rs.randint(0, vocab, size=ROUTER_DISTINCT_LEN).tolist()
            for _ in range(ROUTER_AFTER_KILL))], ROUTER_CONCURRENCY)
    _all_ok(after, ROUTER_NEW, "after the kill")
    # read once R3's lease has run out for certain: a heartbeat R3
    # answered just before its SIGKILL leases it on for ROUTER_LEASE_S,
    # and once its breaker cools down a live lease counts it healthy
    time.sleep(max(0.0, t_kill + ROUTER_LEASE_S + 2 * ROUTER_POLL_S
                   - time.monotonic()))
    st = router.router_status(wire_pb.RouterStatusRequest(), timeout=60)
    check(st.shed == 0 and st.healthy == 2, "router_status after the "
          "kill: %r" % st)
    r3_row = [r for r in st.replica if r.address == addrs["R3"]][0]
    done = [o for o in outs if o["code"] is None]
    return done + after, failed, {
        "streams": len(outs), "explicit_failures": len(failed),
        "killed_at": ("every first chunk" if all_first
                      else "R3's %d seats settled" % len(seated)),
        "completed": len(done), "kill_to_eviction_s": evict_s,
        "eviction_bound_s": ROUTER_LEASE_S + 2 * ROUTER_POLL_S,
        "longest_stream_s": max(o["t_end"] - o["t_send"] for o in outs),
        "redispatched": st.redispatched, "breaker_trips": st.breaker_trips,
        "r3_breaker": r3_row.breaker, "after_kill_completed": len(after),
        "shed": st.shed}


def _handoff_step(model, rs, on_card):
    """(4) A prefill-role and a decode-role replica behind a router with
    --disagg 1: ROUTER_HANDOFF_PROMPTS cold prompts, one at a time,
    each handed off (the decode replica launches no A) and equal to a
    unified replica's stream after its own prefill-only warm-up; then a
    router whose EDL_FAULT_SPEC drops the disagg_handoff hook once
    falls back, and its stream equals the unified replica's cold one."""
    vocab = FLAGSHIP["vocab_size"]
    servers = {r: _tiers_server(model, ROUTER_BLOCKS, role=r).start(
        transport=True) for r in ("prefill", "decode", "unified")}
    addrs = {r: "localhost:%d" % s.port for r, s in servers.items()}
    stubs = {r: wire_service.ServingStub(wire_service.build_channel(a))
             for r, a in addrs.items()}
    dec = servers["decode"].engine
    dec_launches = dict.fromkeys(ROUTER_KERNELS, 0)

    def counted(fn):
        def run(*args):
            before = _tiers_counts()
            try:
                return fn(*args)
            finally:
                _sync("cuda" if on_card else "cpu")
                for n, c in _tiers_delta(before).items():
                    if n in dec_launches:
                        dec_launches[n] += c
        return run

    dec.insert, dec.step = counted(dec.insert), counted(dec.step)
    roles = {addrs["prefill"]: "prefill", addrs["decode"]: "decode"}
    out, children = {}, []
    try:
        for fault in ("", "disagg_handoff:drop:1"):
            child = _router_child([addrs["prefill"], addrs["decode"]],
                                  "the handoff router", fault)
            children.append(child)
            router = wire_service.RouterStub(wire_service.build_channel(
                "localhost:%d" % child.port))
            _wait_polled(router, 2, "the handoff router", roles)
            n = 1 if fault else ROUTER_HANDOFF_PROMPTS
            before = dict(dec_launches)
            ttft = []
            for i in range(n):
                prompt = rs.randint(0, vocab, size=ROUTER_HANDOFF_LEN).tolist()
                got = _routed(router, "router_generate_stream",
                              "s4-%s%d" % ("f" if fault else "", i), prompt,
                              ROUTER_HANDOFF_NEW)
                _all_ok([got], ROUTER_HANDOFF_NEW, "handoff")
                ttft.append((got["t_first"] - got["t_send"]) * 1e3)
                if not fault:
                    stubs["unified"].generate(wire_pb.GenerateRequest(
                        prompt=prompt, max_new_tokens=1, prefill_only=True),
                        timeout=ROUTER_WAIT_S)
                want = _routed(stubs["unified"], "generate_stream", "ref",
                               prompt, ROUTER_HANDOFF_NEW)["tokens"]
                check(got["tokens"] == want, "handoff%s: the routed stream "
                      "leaves the unified replica's from position %s" % (
                          " fallback" if fault else "",
                          _first_divergence(got["tokens"], want)))
            st = router.router_status(wire_pb.RouterStatusRequest(),
                                      timeout=60)
            want_counts = (0, 1) if fault else (n, 0)
            check((st.disagg_handoffs, st.disagg_fallbacks) == want_counts
                  and st.completed == n,
                  "handoff router%s: handoffs %d, fallbacks %d, completed %d"
                  % (" (fault)" if fault else "", st.disagg_handoffs,
                     st.disagg_fallbacks, st.completed))
            launched = {k: dec_launches[k] - before[k] for k in dec_launches}
            if on_card and not fault:
                check(launched["flash_fwd"] == 0 and launched[
                    "paged_decode"] > 0, "the decode replica's launches "
                      "over the handoffs: %s" % launched)
            out["fallback" if fault else "handoffs"] = {
                "prompts": n, "disagg_handoffs": st.disagg_handoffs,
                "disagg_fallbacks": st.disagg_fallbacks,
                "streams_equal_unified": n,
                "client_ttft_ms_p50": float(np.percentile(ttft, 50)),
                "decode_replica_launches": launched,
                "router_ready_s": child.ready_s}
            child.stop()
        exports = stubs["prefill"].server_status(
            wire_pb.ServerStatusRequest(), timeout=60).chain_exports
        check(exports == ROUTER_HANDOFF_PROMPTS, "the prefill replica "
              "exported %d chains" % exports)
    finally:
        for child in children:
            child.close()
        for s in servers.values():
            s.stop(timeout=120)
    for s in servers.values():
        check(s.scheduler.crashed is None,
              "scheduler crashed: %r" % (s.scheduler.crashed,))
    return out


def serving_router_phase(device="cuda"):
    """Phase 29: the port's router (`python -m
    elasticdl_tpu_torch.serving.router_main`, its own process, importing
    no torch) in front of flagship paged replicas (bf16, seeded weights,
    8 slots, 512 blocks of 16, prefix sharing): R1 and R2 in this
    process, R3 a serving-entry process (router_replica_main). Clients
    are RouterStub calls carrying their own trace ids. (1) 24 requests
    in waves of 8 concurrent ones, two heartbeats apart (16 share a
    512-token prefix, 16 streamed); (5)
    router_status in the quiet fleet; (2) overhead: passes of 16 fresh
    requests of the same shapes direct to R1 and through a second router
    fronting R1 alone; (3) R3 SIGKILLed mid-stream; (6) each replica's
    logged operations replayed on a fresh replica's engine, step 1's
    with every A and B launch held to its plain version, and every
    completed routed or direct stream of steps 1-3 equal to its replay;
    (4) the router-driven handoff. Its own generator (ROUTER_SEED)."""
    on_card = device == "cuda"
    rs = np.random.RandomState(ROUTER_SEED)
    model = TransformerLM(device=device, seed=0, **FLAGSHIP)
    out, errs = {}, {}
    workdir = tempfile.mkdtemp(prefix="router_phase_")
    r3_log = os.path.join(workdir, "r3.jsonl")
    r3 = _Child([sys.executable, os.path.abspath(__file__),
                 "--router-replica", r3_log, "--device", device, "--port",
                 "0", "--model_params", _params_str(FLAGSHIP), "--num_slots",
                 "8", "--kv_paged", "1", "--kv_block_size", "16",
                 "--kv_num_blocks", str(ROUTER_BLOCKS)], "replica R3")
    children, servers, logs = [r3], {}, {"R1": [], "R2": []}
    try:
        for name in ("R1", "R2"):
            servers[name] = _tiers_server(model, ROUTER_BLOCKS).start(
                transport=True)
            _ScheduleLog(servers[name], logs[name])
        r3.ready("SERVING_READY")
        out["r3_ready_s"] = r3.ready_s
        addrs = {n: "localhost:%d" % s.port for n, s in servers.items()}
        addrs["R3"] = "localhost:%d" % r3.port
        direct = {n: wire_service.ServingStub(wire_service.build_channel(a))
                  for n, a in addrs.items()}
        for name, stub in direct.items():  # warm, outside the counts
            _all_ok([_routed(stub, "generate_stream", "warm-" + name,
                             [1, 2, 3, 4], 2)], 2, "warm-up")
        main = _router_child([addrs[n] for n in ("R1", "R2", "R3")],
                             "the router")
        children.append(main)
        out["router_ready_s"] = main.ready_s
        router = wire_service.RouterStub(wire_service.build_channel(
            "localhost:%d" % main.port))
        _wait_polled(router, 3, "the router")
        # (1) parity and affinity
        prompts = _router_prompts(rs, ROUTER_SHARED, ROUTER_DISTINCT)
        methods = ["router_generate" if i % 3 == 1 else
                   "router_generate_stream" for i in range(len(prompts))]
        _sync(device)
        att.reset_launch_counts()
        step1 = []
        for w in range(0, len(prompts), ROUTER_CONCURRENCY):
            if w:  # the router sees the warm chains before the next wave
                time.sleep(2 * ROUTER_POLL_S + 0.1)
            step1 += _pool([lambda i=i, p=p: _routed(
                router, methods[i], "s1-%02d" % i, p, ROUTER_NEW)
                for i, p in enumerate(prompts[w:w + ROUTER_CONCURRENCY],
                                      w)], ROUTER_CONCURRENCY)
        _sync(device)
        launches = {n: att.KERNEL_LAUNCHES[n] for n in ROUTER_KERNELS}
        _all_ok(step1, ROUTER_NEW, "parity")
        marks = {n: len(log) for n, log in logs.items()}
        if on_card:
            for name in ("flash_fwd", "paged_decode"):
                check(launches[name] > 0, "kernel %s was not launched in "
                      "this process's replicas on the routed path" % name)
        # (5) router_status in the quiet fleet
        st, own, fleet_ttft = _router_status_step(router, direct, addrs)
        n = len(prompts)
        check(st.routed == st.completed == n and st.shed == 0
              and st.affinity_hits + st.affinity_misses == n
              and st.affinity_hits > 0,
              "router_status after the parity run: routed %d completed %d "
              "shed %d affinity %d / %d" % (st.routed, st.completed, st.shed,
                                            st.affinity_hits,
                                            st.affinity_misses))
        out["parity"] = {
            "requests": n, "streamed": methods.count("router_generate_stream"),
            "unary": methods.count("router_generate"),
            "routed": st.routed, "completed": st.completed, "shed": st.shed,
            "affinity_hits": st.affinity_hits,
            "affinity_misses": st.affinity_misses,
            "prefix_hit_tokens": sum(s.prefix_hit_tokens
                                     for s in own.values()),
            "by_replica": {n: s.completed - 1 for n, s in own.items()},
            "launches_in_process": launches}
        out["status"] = {
            "fleet_ttft_ms": fleet_ttft, "equal_summed_buckets": True,
            "slo": {s.name: {"fast_burn": s.fast_burn,
                             "slow_burn": s.slow_burn,
                             "fast_samples": s.fast_samples,
                             "threshold_ms": s.threshold_ms}
                    for s in st.slo},
            "replica_rows": len(st.replica)}
        # (2) overhead: direct to R1 against a router fronting R1 alone
        second = _router_child([addrs["R1"]], "the R1 router")
        children.append(second)
        r1_router = wire_service.RouterStub(wire_service.build_channel(
            "localhost:%d" % second.port))
        _wait_polled(r1_router, 1, "the R1 router")
        half = ROUTER_OVERHEAD // 2
        passes, step2 = {"direct": [], "router": []}, []
        ttfts = {"direct": [], "router": []}
        for k, label in enumerate(ROUTER_OVERHEAD_ORDER):
            stub, method = ((direct["R1"], "generate_stream")
                            if label == "direct" else
                            (r1_router, "router_generate_stream"))
            res, ttft, summary = _overhead_pass(
                stub, method, "s2-%d" % k, _router_prompts(rs, half, half))
            passes[label].append(summary)
            ttfts[label] += ttft
            step2 += res
        r1_st = r1_router.router_status(wire_pb.RouterStatusRequest(),
                                        timeout=60)
        rtt = []
        for _ in range(ROUTER_STATUS_CALLS):
            t0 = time.perf_counter()
            router.router_status(wire_pb.RouterStatusRequest(), timeout=60)
            rtt.append(time.perf_counter() - t0)
        second.stop()

        def median(label):
            return float(np.median([p["tokens_per_s"]
                                    for p in passes[label]]))

        out["overhead"] = {
            "passes": passes,
            "tokens_per_s_median": {k: median(k) for k in passes},
            "router_over_direct_tokens_per_s": (median("router")
                                                / median("direct")),
            "ttft_ms": {k: {"p50": float(np.percentile(v, 50)),
                            "p99": float(np.percentile(v, 99))}
                        for k, v in ttfts.items()},
            "router_minus_direct_ttft_ms_p50": float(
                np.percentile(ttfts["router"], 50)
                - np.percentile(ttfts["direct"], 50)),
            "router_e2e_ms_p50": r1_st.e2e_p50_ms,
            "router_e2e_ms_p99": r1_st.e2e_p99_ms,
            "router_status_rtt": _pcts(rtt),
            "router_ready_s": second.ready_s}
        # (3) replica death
        step3, failed, out["death"] = _death_step(router, r3, r3_log,
                                                    rs, addrs)
        main.stop()
        for s in servers.values():
            s.stop(timeout=120)
        for s in servers.values():
            check(s.scheduler.crashed is None,
                  "scheduler crashed: %r" % (s.scheduler.crashed,))
        # (6) the replays: step 1's launches held to their plain versions
        r3_entries = _read_schedule(r3_log)
        marks["R3"] = next((i for i, e in enumerate(r3_entries)
                            if e[0] == "insert" and e[1].startswith("s3-")),
                           len(r3_entries))
        r3_s3 = {e[1] for e in r3_entries
                 if e[0] == "insert" and e[1].startswith("s3-")}
        check(r3_s3 and r3_s3 == set(failed), "the streams R3 seated in "
              "step 3 (%s) are not the ones that failed (%s)"
              % (sorted(r3_s3), sorted(failed)))
        refs, replayed = {}, {}
        for name, entries in (("R1", logs["R1"]), ("R2", logs["R2"]),
                              ("R3", r3_entries)):
            got, replayed[name] = _router_replay(model, entries, errs,
                                                 marks[name], on_card)
            check(not set(got) & set(refs), "a trace seated on two "
                  "replicas: %s" % sorted(set(got) & set(refs)))
            refs.update(got)
        compared = 0
        for r in step1 + step2 + step3:
            want = refs.get(r["trace"])
            check(want is not None, "no replica seated %s" % r["trace"])
            check(r["tokens"] == want, "%s leaves its replica's replay "
                  "from position %s" % (r["trace"], _first_divergence(
                      r["tokens"], want)))
            compared += 1
        out["replay"] = {"streams_equal": compared,
                         "step1_equal": len(step1),
                         "launches": replayed}
        out["held_to_plain"] = {k: {"launches": len(v), "max_abs_err": max(v)}
                                for k, v in errs.items()}
        if on_card:
            check(errs.get("flash_fwd") and errs.get("paged_decode"),
                  "the replay held no A or B launch: %s" % sorted(errs))
        del logs, r3_entries, refs
        if on_card:
            torch.cuda.empty_cache()
        # (4) the handoff through the router
        out["handoff"] = _handoff_step(model, rs, on_card)
    finally:
        for child in children:
            child.close()
        for s in servers.values():
            s.stop(drain=False, timeout=120)
        shutil.rmtree(workdir, ignore_errors=True)
    out["launches"] = launches
    del model
    if on_card:
        torch.cuda.empty_cache()
    log("serving_router: %s" % json.dumps(out))
    return out, launches, errs


TIER_SEED = 30
TIER_SHARED, TIER_DISTINCT = 8, 8  # the cells step's 16 requests
TIER_LIVE = 8  # concurrent live streams under the healthy rollout
TIER_LIVE_LEN = 512  # their prompts: 32 blocks, distinct
TIER_BEFORE = 16  # live streams timed through an idle controller first
TIER_PARITY, TIER_PARITY_LEN = 2, 16  # the pinned greedy-parity prompts
# the autoscaler's burst, sent at once: ROUTER_KILL_LEN-token prompts
# with ROUTER_KILL_NEW new tokens each, so the 8 slots stay full and the
# queue deep for seconds, past the 2 s window a scale-up needs (992-token
# prompts with 32 new tokens drained in about 2 s on a fast card)
TIER_BURST = 48
TIER_CKPT_SHARDS = 2
TIER_WAIT_S = 300
TIER_TERMINAL = ("committed", "rolled_back", "aborted")


def _free_base(n):
    """A port p with p .. p+n-1 free on localhost (router_main --cells
    puts cell i on --port + i)."""
    for _ in range(100):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        socks = []
        try:
            for p in range(base, base + n):
                socks.append(socket.socket())
                socks[-1].bind(("localhost", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise SmokeFailure("no %d consecutive free ports" % n)


def _torch_free(pid):
    """The process maps no torch, jaxlib or grpc library."""
    with open("/proc/%d/maps" % pid) as f:
        maps = f.read()
    return not any(name in maps for name in ("/torch/", "libtorch",
                                             "jaxlib", "grpc"))


def _cell_pids(pid):
    """{cell id: pid} of the router cells process `pid` supervises."""
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % name) as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open("/proc/%s/cmdline" % name, "rb") as f:
                argv = f.read().split(b"\0")
        except (OSError, ValueError, IndexError):
            continue
        if ppid == pid and b"--cell_id" in argv:
            out[int(argv[argv.index(b"--cell_id") + 1])] = int(name)
    return out


def _tier_router(argv, what, fault=""):
    return _Child([sys.executable, "-m",
                   "elasticdl_tpu_torch.serving.router_main"] + argv, what,
                  fault)


def _tier_status(port, wait=None, what=""):
    """router_status of the router on `port`; with `wait`, polled until
    wait(status) holds (TIER_WAIT_S), None while it does not answer."""
    stub = wire_service.RouterStub(wire_service.build_channel(
        "localhost:%d" % port))
    deadline = time.monotonic() + TIER_WAIT_S
    while True:
        try:
            st = stub.router_status(wire_pb.RouterStatusRequest(), timeout=30)
        except wire_service.RpcError:
            st = None
        if wait is None or (st is not None and wait(st)):
            return st
        check(time.monotonic() < deadline, "%s: router_status never "
              "showed it: %r" % (what, st))
        time.sleep(0.05)


def _tier_flags(device):
    """The flagship replica's serving.main flags (seeded weights)."""
    return ["--device", device, "--model_params", _params_str(FLAGSHIP),
            "--num_slots", "8", "--kv_paged", "1", "--kv_block_size", "16",
            "--kv_num_blocks", str(ROUTER_BLOCKS)]


def _tier_flat(model, noise_seed=None):
    """The model's params as checkpoint leaves; with `noise_seed`, each
    leaf plus Gaussian noise of its own std (a poisoned version whose
    digests are valid)."""
    from elasticdl_tpu_torch.checkpoint.saver import params_tree
    from elasticdl_tpu_torch.convert import flax_param_path

    flat = params_tree_leaves(params_tree(dict(model.named_parameters()),
                                          flax_param_path))
    if noise_seed is None:
        return flat
    gen = torch.Generator().manual_seed(noise_seed)
    out = {}
    for name, leaf in flat.items():
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
        x = t.float()
        std = float(x.std()) if x.numel() > 1 else 0.0
        x = (x + torch.randn(x.shape, generator=gen) * max(std, 1e-3)).to(
            t.dtype)
        out[name] = x if isinstance(leaf, torch.Tensor) else x.numpy()
    return out


def _tier_link(ckpt, src, dst, drop=None):
    """version-`dst` as hard links to version-`src`'s files (the same
    bytes, byte for byte), less the file `drop` (a torn version)."""
    tmp = os.path.join(ckpt, ".staging-%d" % dst)
    os.makedirs(tmp)
    src_dir = os.path.join(ckpt, "version-%d" % src)
    for name in os.listdir(src_dir):
        if name != drop:
            os.link(os.path.join(src_dir, name), os.path.join(tmp, name))
    os.rename(tmp, os.path.join(ckpt, "version-%d" % dst))


def _tier_journal(path):
    with open(os.path.join(path, "journal.jsonl")) as f:
        return [json.loads(x) for x in f if x.strip()]


def _fronted(front, method, trace, prompt, new, out=None):
    """One call through the CellFront, recorded as _routed records one."""
    from elasticdl_tpu_torch.serving.router import RouterError

    out = {} if out is None else out
    out.update(trace=trace, tokens=[], done=False, code=None, chunks=0,
               t_send=time.perf_counter())
    req = wire_pb.GenerateRequest(prompt=prompt, max_new_tokens=new,
                                  trace_id=trace)
    try:
        if method == "stream":
            for chunk in front.generate_stream(req, timeout=ROUTER_WAIT_S):
                if not out["chunks"]:
                    out["t_first"] = time.perf_counter()
                out["chunks"] += 1
                out["tokens"].extend(chunk.tokens)
                out["done"] = chunk.done
        else:
            resp = front.generate(req, timeout=ROUTER_WAIT_S)
            out["t_first"] = time.perf_counter()
            out["tokens"] = list(resp.tokens)[len(prompt):]
            out["done"] = True
    except RouterError as e:
        out["code"], out["details"] = e.code, str(e)
    out["t_end"] = time.perf_counter()
    return out


def _tier_outcomes(outs, new, what):
    """(completed, failed explicitly, lost) of calls: a failure is
    explicit when it carries a status, and a stream's after its first
    chunk must say it was lost mid-stream; a call that neither ends with
    all its tokens nor fails so is lost."""
    done = [o for o in outs if o.get("code") is None and o.get("done")
            and len(o["tokens"]) == new]
    failed = [o for o in outs if o.get("code") is not None]
    for o in failed:
        check(not o["chunks"] or (o["code"] == "UNAVAILABLE"
                                  and "mid-stream" in o.get("details", "")),
              "%s: %s failed %s after %d chunks: %s" % (
                  what, o["trace"], o["code"], o["chunks"],
                  o.get("details")))
    return done, failed, len(outs) - len(done) - len(failed)


def _tier_idle(servers):
    """Until the replicas have nothing queued or seated."""
    deadline = time.monotonic() + TIER_WAIT_S
    while not all(len(s.queue) == 0 and s.engine.active_count() == 0
                  for s in servers):
        check(time.monotonic() < deadline, "the replicas never went idle")
        time.sleep(0.05)


def _tier_cells(rs, addrs, workdir):
    """(1) router_main --cells 2 over R1 and R2, a CellFront in this
    process: 16 requests at once (8 sharing a 512-token prefix whose
    family cell 0 owns, every third unary), cell 0 SIGKILLed once one of
    its streams has its first chunk; then cell 0's restart and a third
    cell that learns the fleet from the journal alone."""
    from elasticdl_tpu_torch.serving.prefix_affinity import (
        HashRing,
        prefix_fingerprint,
    )
    from elasticdl_tpu_torch.serving.router_cell import CellFront

    vocab = FLAGSHIP["vocab_size"]
    base = _free_base(2)
    journal = os.path.join(workdir, "cells")
    cells = ["localhost:%d" % (base + i) for i in range(2)]
    ring = HashRing(cells)

    def owner(prompt):
        return ring.lookup(prefix_fingerprint(prompt, 16, 4))

    prefix = rs.randint(0, vocab, size=ROUTER_PREFIX_LEN).tolist()
    while owner(prefix) != cells[0]:
        prefix = rs.randint(0, vocab, size=ROUTER_PREFIX_LEN).tolist()
    prompts = _interleave(
        [prefix + rs.randint(0, vocab, size=ROUTER_SUFFIX_LEN).tolist()
         for _ in range(TIER_SHARED)],
        [rs.randint(0, vocab, size=ROUTER_DISTINCT_LEN).tolist()
         for _ in range(TIER_DISTINCT)])
    methods = ["unary" if i % 3 == 1 else "stream"
               for i in range(len(prompts))]
    owners = [owner(p) for p in prompts]
    argv = ["--cells", "2", "--port", str(base), "--cell_journal_dir",
            journal]
    for addr in addrs:
        argv += ["--replica", addr]
    sup = _tier_router(argv, "the cell supervisor")
    children, front = [sup], None
    try:
        sup.line("ROUTER_CELLS_READY")
        for i in range(2):
            _tier_status(base + i, lambda s: s.healthy == 2 and all(
                r.kv_blocks_free > 0 for r in s.replica), "cell %d" % i)
        pids = {}
        deadline = time.monotonic() + 60
        while len(pids) < 2:
            check(time.monotonic() < deadline, "the cells' processes")
            pids = _cell_pids(sup.proc.pid)
            time.sleep(0.05)
        clean = [_torch_free(p) for p in [sup.proc.pid] + list(pids.values())]
        front = CellFront(cells, block_tokens=16, reroute_window_secs=60)
        outs = [{} for _ in prompts]
        threads = [threading.Thread(target=_fronted, daemon=True, args=(
            front, methods[i], "c1-%02d" % i, p, ROUTER_NEW, outs[i]))
            for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + ROUTER_WAIT_S
        while not any("t_first" in o for o, m, c in zip(outs, methods, owners)
                      if m == "stream" and c == cells[0]):
            check(time.monotonic() < deadline, "no stream through cell 0 "
                  "delivered a chunk")
            time.sleep(0.001)
        t_kill = time.monotonic()
        os.kill(pids[0], signal.SIGKILL)
        for t in threads:
            t.join(timeout=ROUTER_DISPATCH_S + 60)
        done, failed, lost = _tier_outcomes(outs, ROUTER_NEW, "cells")
        check(lost == 0, "cells: %d accepted requests lost" % lost)
        check(front.counters["rerouted"] > 0, "cells: nothing rerouted "
              "after cell 0's kill: %s" % front.counters)
        st = _tier_status(base, lambda s: s.replicas == 2
                          and s.cell_restarts >= 1, "cell 0's restart")
        restart_s = time.monotonic() - t_kill
        check(st.journal_replayed > 0 and st.cell_id == 0,
              "the restarted cell 0: %r" % st)
        pids = _cell_pids(sup.proc.pid)
        third = _tier_router(["--cell_id", "2", "--cells", "3", "--port",
                              "0", "--cell_journal_dir", journal],
                             "a third cell")
        children.append(third)
        third_st = _tier_status(third.ready("ROUTER_READY"),
                                lambda s: s.replicas == 2, "the third cell")
        check(sorted(r.address for r in third_st.replica) == sorted(addrs)
              and any(l.startswith("ROUTER_CELL cell=2 cells=3")
                      for l in third.lines),
              "the third cell: %r" % third_st)
        clean += [_torch_free(p) for p in [third.proc.pid] + list(
            pids.values())]
        third.stop()
        sup.stop()
    finally:
        if front is not None:
            front.close()
        for child in children:
            child.close()
    ttft = [(o["t_first"] - o["t_send"]) * 1e3 for o in done]
    return done, {
        "requests": len(prompts), "shared_prefix": TIER_SHARED,
        "shared_on_one_cell": len({c for c, p in zip(owners, prompts)
                                   if p[:ROUTER_PREFIX_LEN] == prefix}) == 1,
        "unary": methods.count("unary"),
        "routed": front.counters["routed"],
        "completed": len(done), "rerouted": front.counters["rerouted"],
        "cell_failures": front.counters["cell_failures"],
        "failed_explicitly": len(failed), "lost": lost,
        "client_ttft_ms_p50": float(np.percentile(ttft, 50)),
        "kill_to_restarted_s": restart_s,
        "restarted_journal_replayed": st.journal_replayed,
        "restarted_cell_restarts": st.cell_restarts,
        "restarted_replicas": st.replicas,
        "third_cell_replicas_learned": third_st.replicas,
        "third_cell_journal_replayed": third_st.journal_replayed,
        "supervisor_ready_s": sup.ready_s,
        "processes_torch_free": "%d/%d" % (sum(clean), len(clean))}, all(
            clean)


def _tier_live(stub, prompts, label, stop=None):
    """Streams of `prompts` through `stub` on TIER_LIVE client threads,
    each thread its share in order; with `stop`, each thread cycles
    through its share until stop() holds. Returns the results."""
    outs = []
    lock = threading.Lock()
    deadline = time.monotonic() + TIER_WAIT_S

    def worker(k):
        n = 0
        while stop is not None or n < len(prompts[k::TIER_LIVE]):
            if stop is not None and (stop() or time.monotonic() > deadline):
                return
            share = prompts[k::TIER_LIVE]
            o = _routed(stub, "router_generate_stream", "%s-%d-%03d" % (
                label, k, n), share[n % len(share)], ROUTER_NEW)
            with lock:
                outs.append(o)
            n += 1

    threads = [threading.Thread(target=worker, args=(k,), daemon=True)
               for k in range(TIER_LIVE)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIER_WAIT_S + ROUTER_WAIT_S)
        check(not t.is_alive(), "a live stream hangs")
    return outs


def _ttft(outs):
    ms = [(o["t_first"] - o["t_send"]) * 1e3 for o in outs if "t_first" in o]
    return {"streams": len(outs), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def _swaps(journal, target):
    """{address: reloads the controller made to `target`} by journal."""
    out = {}
    for ev in _tier_journal(journal):
        if (ev["ev"] == "swap_done" and ev["ok"] and ev["to"] == target
                and "note" not in ev):
            out[ev["addr"]] = out.get(ev["addr"], 0) + 1
    return out


def _tier_rollout(rs, servers, addrs, model, ckpt, workdir):
    """(2) Four rollouts of R1 and R2 by router_main processes over one
    journal: version 2 (version 1's bytes) under TIER_LIVE live streams,
    version 4 (torn), version 3 (perturbed, valid digests), version 5
    (version 1's bytes) with the controller SIGKILLed before its second
    swap and resumed by a router given only the journal."""
    vocab = FLAGSHIP["vocab_size"]
    journal = os.path.join(workdir, "rollout")
    _tier_save(ckpt, 3, _tier_flat(model, noise_seed=TIER_SEED))
    _tier_link(ckpt, 1, 2)
    _tier_link(ckpt, 1, 4, drop="variables-1-of-%d.ckpt" % TIER_CKPT_SHARDS)
    _tier_link(ckpt, 1, 5)
    parity = ";".join(",".join(str(t) for t in rs.randint(
        0, vocab, size=TIER_PARITY_LEN)) for _ in range(TIER_PARITY))
    fleet = []
    for addr in addrs:
        fleet += ["--replica", addr]
    args = ["--port", "0", "--rollout_journal_dir", journal,
            "--rollout_checkpoint_dir", ckpt, "--rollout_wave_size", "1",
            "--rollout_soak_secs", "1", "--rollout_parity_prompts",
            parity] + fleet
    live = [rs.randint(0, vocab, size=TIER_LIVE_LEN).tolist()
            for _ in range(4 * TIER_LIVE)]
    out, clean, children = {}, [], []

    def run(target, fault="", argv=None):
        child = _tier_router((argv or args) + (
            ["--rollout", str(target)] if target is not None else []),
            "the rollout router", fault)
        children.append(child)
        port = child.ready("ROUTER_READY")
        clean.append(_torch_free(child.proc.pid))
        return child, port, wire_service.RouterStub(
            wire_service.build_channel("localhost:%d" % port))

    def finish(port, target):
        # the journal's last rollout shows until this one begins
        return _tier_status(port, lambda s: s.rollout.phase in TIER_TERMINAL
                            and s.rollout.target_version == target,
                            "the rollout to version %d" % target)

    try:
        child, port, stub = run(None)  # an idle controller: TTFT before
        _wait_polled(stub, 2, "the rollout router")
        before = _tier_live(stub, live[:TIER_BEFORE], "r0")
        _all_ok(before, ROUTER_NEW, "before the rollout")
        child.stop()
        t0 = time.monotonic()
        child, port, stub = run(2)
        state = {}

        def terminal():
            if "st" not in state:
                st = _tier_status(port)
                phase = (st.rollout.phase if st is not None
                         and st.rollout.target_version == 2 else "idle")
                if phase != "idle":
                    state.setdefault("t_stage", time.monotonic())
                if phase in TIER_TERMINAL:
                    state["st"], state["t"] = st, time.monotonic()
            return "st" in state

        during = _tier_live(stub, live, "r1", stop=terminal)
        st = state.get("st") or finish(port, 2)
        _all_ok(during, ROUTER_NEW, "under the healthy rollout")
        check(st.rollout.phase == "committed" and st.rollout.verdict == "pass",
              "the healthy rollout: %r" % st.rollout)
        swaps = _swaps(journal, 2)
        order = [ev["addr"] for ev in _tier_journal(journal)
                 if ev["ev"] == "swap_done" and ev["to"] == 2]
        check(swaps == {a: 1 for a in addrs} and order == sorted(addrs),
              "the healthy rollout's swaps: %s in the order %s"
              % (swaps, order))
        st = _tier_status(port, lambda s: sorted(
            r.model_version for r in s.replica) == [2, 2], "version 2")
        child.stop()
        out["healthy"] = {
            "phase": "committed", "canary_first": True,
            "start_to_commit_s": state.get("t", time.monotonic()) - t0,
            "stage_to_commit_s": (state["t"] - state["t_stage"]
                                  if "t_stage" in state else None),
            "swaps_per_replica": sorted(swaps.values()),
            "parity_matched": "%d/%d" % (TIER_PARITY, TIER_PARITY),
            "live_streams": len(during), "live_failures": 0,
            "fleet_versions": sorted(r.model_version for r in st.replica),
            "ttft_before": _ttft(before), "ttft_during": _ttft(during),
            "router_ready_s": child.ready_s}
        child, port, _stub = run(4)
        st = finish(port, 4)
        torn = _swaps(journal, 4)
        check(st.rollout.phase == "aborted" and not torn
              and "verification" in st.rollout.last_error,
              "the torn rollout: %r" % st.rollout)
        child.stop()
        out["torn"] = {"phase": st.rollout.phase, "swaps": len(torn)}
        child, port, _stub = run(3)
        st = finish(port, 3)
        versions = [s.model_version for s in servers]
        check(st.rollout.phase == "rolled_back"
              and st.rollout.verdict == "parity_fail" and versions == [2, 2],
              "the poisoned rollout: %r, the fleet on %s"
              % (st.rollout, versions))
        matched = re.search(r"reproduced (\d+)/(\d+)", st.rollout.last_error)
        child.stop()
        out["poisoned"] = {
            "phase": st.rollout.phase, "verdict": st.rollout.verdict,
            "parity_matched": "%s/%s" % matched.groups() if matched else "",
            "rollbacks": st.rollout.rollbacks,
            "final_fleet_versions": versions}
        before_reloads = [s.scheduler.reloads for s in servers]
        child, port, _stub = run(5, fault="rollout_swap:kill:1:skip=1")
        try:
            rc = child.proc.wait(timeout=TIER_WAIT_S)
        except subprocess.TimeoutExpired:
            rc = "alive"
        check(rc == -signal.SIGKILL, "the rollout_swap kill rule left the "
              "controller %s" % rc)
        mixed = sorted(s.model_version for s in servers)
        child, port, _stub = run(None, argv=["--port", "0",
                                             "--rollout_journal_dir",
                                             journal] + fleet)
        st = finish(port, 5)
        resumed = _swaps(journal, 5)
        reloads = [s.scheduler.reloads - b
                   for s, b in zip(servers, before_reloads)]
        check(st.rollout.phase == "committed" and st.rollout.target_version
              == 5 and resumed == {a: 1 for a in addrs} and reloads == [1, 1]
              and [s.model_version for s in servers] == [5, 5],
              "the resumed rollout: %r, swaps %s, reloads %s"
              % (st.rollout, resumed, reloads))
        child.stop()
        out["resumed"] = {
            "fleet_at_kill": mixed, "phase": st.rollout.phase,
            "swaps_per_replica": sorted(resumed.values()),
            "replica_reloads": reloads,
            "rollout_restarts": st.rollout.rollout_restarts}
    finally:
        for child in children:
            child.close()
    out["processes_torch_free"] = "%d/%d" % (sum(clean), len(clean))
    return out, all(clean)


def _tier_alone(addr, ref, prompt, label):
    """`prompt` alone on the replica at `addr` and alone on the
    reference replica: the same tokens."""
    stub = wire_service.ServingStub(wire_service.build_channel(addr))
    got = _routed(stub, "generate_stream", label, prompt, ROUTER_NEW)
    want = _routed(ref, "generate_stream", label + "-ref", prompt, ROUTER_NEW)
    _all_ok([got, want], ROUTER_NEW, label)
    check(got["tokens"] == want["tokens"], "%s: the adopted replica leaves "
          "the reference from position %s" % (label, _first_divergence(
              got["tokens"], want["tokens"])))


def _tier_autoscale(rs, ref, device, workdir):
    """(3) router_main --autoscale --min_replicas 1 --max_replicas 2 over
    flagship entries it spawns: spawn and adopt, a burst of TIER_BURST
    requests scales to 2, a SIGKILLed replica is replaced, idle time
    drains back to 1, and the router SIGKILLed and restarted on its
    journal re-adopts the live replica."""
    import shlex

    vocab = FLAGSHIP["vocab_size"]
    journal = os.path.join(workdir, "fleet")
    argv = ["--port", "0", "--autoscale", "--min_replicas", "1",
            "--max_replicas", "2", "--journal_dir", journal,
            "--replica_args", " ".join(shlex.quote(a) for a in _tier_flags(
                device) + ["--port", "0", "--warmup_tokens", "4"])]
    out, children, alone = {}, [], 0

    def seats():
        """{seat: (pid, address)} of the journal's live seats."""
        live = {}
        for ev in _tier_journal(journal):
            if ev["ev"] == "adopt":
                live[ev["seat"]] = (ev["pid"], ev["address"])
            elif ev["ev"] in ("retire", "reap"):
                live.pop(ev["seat"], None)
        return live

    def fresh():
        return rs.randint(0, vocab, size=ROUTER_DISTINCT_LEN).tolist()

    try:
        router = _tier_router(argv, "the autoscaling router")
        children.append(router)
        port = router.ready("ROUTER_READY")
        t0 = time.monotonic()
        st = _tier_status(port, lambda s: s.autoscaler.live == 1 and all(
            r.kv_blocks_free > 0 for r in s.replica) and s.healthy == 1,
            "the first adoption")
        out["spawn_to_adopt_s"] = time.monotonic() - t0
        clean = [_torch_free(router.proc.pid)]
        (pid0, addr0), = seats().values()
        check(not _torch_free(pid0), "the spawned replica maps no torch")
        _tier_alone(addr0, ref, fresh(), "alone-0")
        alone += 1
        stub = wire_service.RouterStub(wire_service.build_channel(
            "localhost:%d" % port))
        burst = [rs.randint(0, vocab, size=ROUTER_KILL_LEN).tolist()
                 for _ in range(TIER_BURST)]
        outs = [{} for _ in burst]
        threads = [threading.Thread(target=_routed, daemon=True, args=(
            stub, "router_generate_stream", "a2-%02d" % i, p,
            ROUTER_KILL_NEW, outs[i])) for i, p in enumerate(burst)]
        t_burst = time.monotonic()
        for t in threads:
            t.start()
        st = _tier_status(port, lambda s: s.autoscaler.live == 2,
                          "the scale-up")
        out["burst_to_second_adopt_s"] = time.monotonic() - t_burst
        for t in threads:
            t.join(timeout=ROUTER_DISPATCH_S + 60)
        done, failed, lost = _tier_outcomes(outs, ROUTER_KILL_NEW, "burst")
        check(lost == 0 and st.autoscaler.scale_ups == 1,
              "the burst: %d lost, %r" % (lost, st.autoscaler))
        out["burst"] = {"requests": len(burst), "completed": len(done),
                        "failed_explicitly": len(failed), "lost": lost,
                        "failure_codes": sorted(o["code"] for o in failed),
                        "client_ttft": _ttft(done)}
        live = seats()
        check(len(live) == 2, "two live seats: %s" % live)
        _tier_alone(live[max(live)][1], ref, fresh(), "alone-1")
        alone += 1
        victim = live[min(live)]
        t_kill = time.monotonic()
        os.kill(victim[0], signal.SIGKILL)
        st = _tier_status(port, lambda s: s.autoscaler.replacements == 1
                          and s.autoscaler.live == 2
                          and victim[1] not in [r.address for r in s.replica]
                          and s.healthy == 2, "the replacement")
        out["kill_to_replacement_s"] = time.monotonic() - t_kill
        live = seats()
        _tier_alone(live[max(live)][1], ref, fresh(), "alone-2")
        alone += 1
        t_idle = time.monotonic()
        _tier_status(port, lambda s: s.autoscaler.draining == 1,
                     "the scale-down's drain")
        t_drain = time.monotonic()
        st = _tier_status(port, lambda s: s.autoscaler.live == 1
                          and s.autoscaler.draining == 0
                          and s.autoscaler.scale_downs == 1, "the retire")
        out["idle_to_drain_s"] = t_drain - t_idle
        out["drain_to_retire_s"] = time.monotonic() - t_drain
        retired = [ev for ev in _tier_journal(journal)
                   if ev["ev"] == "retire"]
        check(len(retired) == 1 and retired[0].get("rc") == 0,
              "the drained replica's retire: %s" % retired)
        spawned = sum(ev["ev"] == "launched" for ev in _tier_journal(journal))
        (pid_live, _addr), = seats().values()
        router.proc.kill()
        router.proc.wait()
        router = _tier_router(argv, "the restarted autoscaling router")
        children.append(router)
        port = router.ready("ROUTER_READY")
        st = _tier_status(port, lambda s: s.autoscaler.live == 1
                          and s.healthy == 1, "the re-adoption")
        respawned = sum(ev["ev"] == "launched"
                        for ev in _tier_journal(journal)) - spawned
        check(respawned == 0 and st.autoscaler.supervisor_restarts == 1
              and seats()[max(seats())][0] == pid_live,
              "the restarted router: %d spawns, %r" % (respawned,
                                                       st.autoscaler))
        clean.append(_torch_free(router.proc.pid))
        router.stop()
        check(not os.path.exists("/proc/%d" % pid_live) or open(
            "/proc/%d/stat" % pid_live).read().rsplit(")", 1)[1].split()[0]
            == "Z", "the drained replica outlived its router")
        out.update(
            spawns_after_restart=respawned,
            supervisor_restarts=st.autoscaler.supervisor_restarts,
            scale_ups=st.autoscaler.scale_ups,
            scale_downs=st.autoscaler.scale_downs,
            replacements=st.autoscaler.replacements,
            spawns=spawned, lost=lost, alone_equal_reference=alone,
            processes_torch_free="%d/%d" % (sum(clean), len(clean)))
    finally:
        for child in children:
            child.close()
        if os.path.exists(os.path.join(journal, "journal.jsonl")):
            for pid, _addr in seats().values():  # left by a failed step
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
    return out, all(clean)


def _tier_save(ckpt, version, flat):
    CheckpointSaver(None, ckpt, num_shards=TIER_CKPT_SHARDS).save_flat(
        flat, version)


def serving_router_tier_phase(device="cuda"):
    """Phase 30: the rest of the router tier, router_main processes that
    import no torch in front of flagship replicas: R1 and R2 in this
    process (serving.main's build_server over checkpoint version 1 of
    the seeded flagship, --reload_poll_secs 0, their engine operations
    logged), a reference replica over the same weights, and the
    autoscaler's own serving.main processes. (1) cells, (2) rollouts,
    (3) the autoscaler; then R1's and R2's logged operations of step (1)
    replayed on a fresh engine with every A and B launch held to its
    plain version, and every completed stream of step (1) equal to a
    replay of its trace. Its own generator (TIER_SEED)."""
    on_card = device == "cuda"
    rs = np.random.RandomState(TIER_SEED)
    model = TransformerLM(device=device, seed=0, **FLAGSHIP)
    workdir = tempfile.mkdtemp(prefix="router_tier_")
    ckpt = os.path.join(workdir, "ckpt")
    _tier_save(ckpt, 1, _tier_flat(model))
    out, errs, servers, logs = {}, {}, [], [[], []]
    try:
        for oplog in logs:
            server = serving_main.build_server(serving_main.parse_serving_args(
                _tier_flags(device) + ["--checkpoint_dir", ckpt,
                                       "--reload_poll_secs", "0", "--port",
                                       "0"]))
            _ScheduleLog(server, oplog)
            servers.append(server.start(transport=True))
        ref_server = _tiers_server(model, ROUTER_BLOCKS).start(transport=True)
        servers.append(ref_server)
        addrs = ["localhost:%d" % s.port for s in servers[:2]]
        ref = wire_service.ServingStub(wire_service.build_channel(
            "localhost:%d" % ref_server.port))
        for stub in [wire_service.ServingStub(wire_service.build_channel(a))
                     for a in addrs] + [ref]:  # warm, outside the counts
            _all_ok([_routed(stub, "generate_stream", "warm", [1, 2, 3, 4],
                             2)], 2, "warm-up")
        check([s.model_version for s in servers[:2]] == [1, 1],
              "R1 and R2 serve versions %s"
              % [s.model_version for s in servers[:2]])
        _sync(device)
        att.reset_launch_counts()
        step1, out["cells"], clean_cells = _tier_cells(rs, addrs, workdir)
        _tier_idle(servers[:2])
        marks = [len(log) for log in logs]
        out["rollout"], clean_roll = _tier_rollout(rs, servers[:2], addrs,
                                                   model, ckpt, workdir)
        out["autoscaler"], clean_auto = _tier_autoscale(rs, ref, device,
                                                        workdir)
        _sync(device)
        launches = {n: att.KERNEL_LAUNCHES[n] for n in ROUTER_KERNELS}
        if on_card:
            for name in ("flash_fwd", "paged_decode"):
                check(launches[name] > 0, "kernel %s was not launched in "
                      "this process's replicas on the router tier's path"
                      % name)
        check(clean_cells and clean_roll and clean_auto, "a router-side "
              "process maps torch: %s" % {k: v["processes_torch_free"]
                                          for k, v in out.items()})
        for s in servers:
            s.stop(timeout=120)
        for s in servers:
            check(s.scheduler.crashed is None,
                  "scheduler crashed: %r" % (s.scheduler.crashed,))
        refs, replayed = {}, {}
        for name, oplog, mark in zip(("R1", "R2"), logs, marks):
            got, replayed[name] = _router_replay(model, oplog[:mark], errs,
                                                 mark, on_card, reseat=True)
            for trace, streams in got.items():
                refs.setdefault(trace, []).extend(streams)
        for r in step1:
            check(r["tokens"] in refs.get(r["trace"], []), "%s leaves every "
                  "replay of its trace" % r["trace"])
        out["replay"] = {"streams_equal": len(step1),
                         "seats": sum(map(len, refs.values())),
                         "launches": replayed}
        out["held_to_plain"] = {k: {"launches": len(v), "max_abs_err": max(v)}
                                for k, v in errs.items()}
        if on_card:
            check(errs.get("flash_fwd") and errs.get("paged_decode"),
                  "the replay held no A or B launch: %s" % sorted(errs))
    finally:
        for s in servers:
            s.stop(drain=False, timeout=120)
        shutil.rmtree(workdir, ignore_errors=True)
    out["launches"] = launches
    del model
    if on_card:
        torch.cuda.empty_cache()
    log("serving_router_tier: %s" % json.dumps(out))
    return out, launches, errs


TAB_SEED = 31
TAB_STEPS = 4  # LocalExecutor steps a model takes
# the tabular models' minibatch: heart's published table has 303 rows and
# census-income 32,561, so 64 gives each model several steps of real
# batches; the CTR models' minibatch is the order Criteo CTR models train
# at (the DLRM phase takes 4096), halved so that the host's per-record
# transform (26 md5 hashes a record, a few thousand records/s on one
# core) keeps the phase within its 90 s
TAB_BATCH = 64
TAB_CTR_BATCH = 2048
TAB_CTR_BUCKETS = 1_000_000  # dac_ctr's published MAX_HASHING_BUCKET_SIZE
TAB_LOSS_TOL_REL = 1e-4  # first loss, card against the CPU port
TAB_EMB_DIM = 8  # the dac_ctr deep tables' dim
TAB_PAD_SHARE = 0.1  # the id slots the kernel E check sets to PADDING_ID
TAB_EMB_TOL_REL = 1e-6
TAB_KERNELS = ("embedding_gather", "embedding_gather_many")
# the models whose step is profiled on the card: the CTR model with the
# least and the one with the most dense work
TAB_PROFILED = ("dac_ctr_wide_deep", "dac_ctr_xdeepfm")
# name -> (--model_def in the zoo, generator, model_params, minibatch)
TAB_MODELS = {
    "heart": ("heart_functional_api.heart_functional_api.custom_model",
              "gen_heart_like", "", TAB_BATCH),
    "census_dnn_functional_api": (
        "census_dnn_model.census_functional_api.custom_model",
        "gen_census_raw", "", TAB_BATCH),
    "census_dnn_sequential": (
        "census_dnn_model.census_sequential.custom_model",
        "gen_census_raw", "", TAB_BATCH),
    "census_dnn_subclass": ("census_dnn_model.census_subclass.custom_model",
                            "gen_census_raw", "", TAB_BATCH),
    "census_wide_deep": ("census_wide_deep_model.wide_deep_functional_api."
                         "custom_model", "gen_census_raw", "", TAB_BATCH),
    "sqlflow_dnn": ("census_model_sqlflow.dnn.census_dnn.custom_model",
                    "gen_census_raw", "", TAB_BATCH),
    "sqlflow_wide_deep": ("census_model_sqlflow.wide_and_deep."
                          "census_wide_and_deep.custom_model",
                          "gen_census_raw", "", TAB_BATCH),
}
for _ctr in ("wide_deep", "deepfm", "dcn", "xdeepfm"):
    TAB_MODELS["dac_ctr_" + _ctr] = (
        "dac_ctr.elasticdl_train.custom_model", "gen_criteo_like",
        "ctr_model='%s'; max_hashing_bucket_size=%d" % (_ctr,
                                                         TAB_CTR_BUCKETS),
        TAB_CTR_BATCH)


def _tab_zoo_dir():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "elasticdl_tpu_torch", "model_zoo")


def _tab_records(gen, batch, workdir, seed):
    """The training (TAB_STEPS batches) and validation (one batch)
    record dirs of a generator and minibatch, written once."""
    train = os.path.join(workdir, "%s-%d-train" % (gen, batch))
    valid = os.path.join(workdir, "%s-%d-valid" % (gen, batch))
    if not os.path.isdir(train):
        getattr(port_recordio_gen, gen)(train, num_files=1,
                                        records_per_file=batch * TAB_STEPS,
                                        seed=seed)
        getattr(port_recordio_gen, gen)(valid, num_files=1,
                                        records_per_file=batch,
                                        seed=seed + 1)
    return train, valid


def _tab_host_rate(spec, train, n):
    """dataset_fn's records/s over the first `n` training records, alone
    (no step): decode, transform and the shuffle buffer."""
    (name,) = os.listdir(train)
    records = list(Scanner(os.path.join(train, name)))[:n]
    t0 = time.perf_counter()
    n = sum(1 for _ in spec.dataset_fn(Dataset.from_list(records),
                                       Mode.TRAINING, None))
    return n / (time.perf_counter() - t0)


def _tab_train(name, workdir, device):
    """TAB_STEPS LocalExecutor steps and one evaluation of one zoo model
    on `device`, then its first step again on the CPU port from the same
    weights and batch. Returns the model's report."""
    model_def, gen, params, batch = TAB_MODELS[name]
    train, valid = _tab_records(gen, batch, workdir, TAB_SEED)
    spec = get_model_spec(_tab_zoo_dir(), model_def)
    executor = LocalExecutor(
        spec, training_data=train, validation_data=valid,
        minibatch_size=batch, records_per_task=batch * TAB_STEPS,
        model_params=params, device=device)
    trainer = executor.trainer
    init = {k: v.detach().to("cpu", copy=True)
            for k, v in trainer.model.state_dict().items()}
    param_bytes = sum(v.numel() * v.element_size() for v in init.values())
    steps, first = [], {}
    step_fn = trainer.train_step

    def recorded(state, batch_, true_count=None):
        if not first:
            first.update(features={k: np.array(v) for k, v in
                                   batch_[0].items()},
                         labels=np.array(batch_[1]), true_count=true_count)
        _sync(device)
        t0 = time.perf_counter()
        out = step_fn(state, batch_, true_count)
        _sync(device)
        steps.append((time.perf_counter() - t0) * 1e3)
        return out

    trainer.train_step = recorded
    base = None
    if device == "cuda":
        torch.cuda.synchronize()
        # what the process holds already (earlier phases, this model's
        # parameters): the peak below counts it too
        base = int(torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
    state, metrics = executor.train()
    peak = (int(torch.cuda.max_memory_allocated()) if device == "cuda"
            else None)
    losses = list(executor.losses)
    check(state is not None and state.step == TAB_STEPS
          and len(losses) == TAB_STEPS,
          "%s took %d steps, not %d" % (name, len(losses), TAB_STEPS))
    check(all(math.isfinite(x) for x in losses),
          "%s: a non-finite loss in %s" % (name, losses))
    want_metrics = (("logits_accuracy", "probs_auc")
                    if "logits_accuracy" in metrics else ("accuracy",))
    check(sorted(metrics) == sorted(want_metrics)
          and all(0.0 <= metrics[k] <= 1.0 for k in want_metrics),
          "%s evaluation metrics %s" % (name, metrics))
    on_device = {p.device.type for p in trainer.model.parameters()}
    check(on_device == {torch.device(device).type},
          "%s's parameters lie on %s" % (name, sorted(on_device)))
    # the instance attribute closes a cycle (the wrapper holds the bound
    # method, which holds the trainer): drop it, so the model, its
    # gradients and Adam's moments go before the next model is built
    del trainer.train_step
    profile = None
    if device == "cuda" and name in TAB_PROFILED:
        profile = profile_steps(trainer, state, (first["features"],
                                                 first["labels"]))
        log("tabular_zoo %s step profile: %s" % (name, json.dumps(profile)))
    del executor, trainer, state, step_fn, recorded
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    # the first step again on the CPU port, from the same weights and batch
    cpu = Trainer(spec, model_params=params, device="cpu")
    cpu_state = cpu.init_state(None, params=init)
    _cpu_state, cpu_loss = cpu.train_step(
        cpu_state, (first["features"], first["labels"]), first["true_count"])
    rel = abs(losses[0] - cpu_loss) / max(abs(cpu_loss), 1e-12)
    check(rel <= TAB_LOSS_TOL_REL,
          "%s: first loss %.8f on %s, %.8f on the CPU (rel %.3g > %g)"
          % (name, losses[0], device, cpu_loss, rel, TAB_LOSS_TOL_REL))
    del cpu, cpu_state, _cpu_state, init
    return {
        "model_def": model_def, "model_params": params, "minibatch": batch,
        "steps": TAB_STEPS, "losses": losses, "first_loss_cpu": cpu_loss,
        "first_loss_rel_err": rel, "eval": metrics,
        "param_bytes": int(param_bytes), "peak_memory_bytes": peak,
        "memory_allocated_before_bytes": base,
        "step_ms": steps, "step_p50_ms": float(np.median(steps)),
        "dataset_fn_records_per_s": _tab_host_rate(spec, train, batch),
        "step_profile": profile,
    }


def _tab_embedding_column(workdir, device):
    """Kernel E through the preprocessing path: an embedding_column over
    the concatenated_categorical_column of the 38 dac_ctr groups at their
    published id spaces (5.50 M rows, dim 8), ids from the CTR transform
    (transform_feature) of Criteo-like records with TAB_PAD_SHARE of the
    slots PADDING_ID,
    looked up with the sum and the mean combiner on `device` and held to
    the same layer on the CPU (the plain version). Returns (report,
    launches by wrapper, max abs errors)."""
    max_ids = group_max_ids(FEATURE_GROUPS, TAB_CTR_BUCKETS)
    train, _valid = _tab_records("gen_criteo_like", TAB_CTR_BATCH, workdir,
                                 TAB_SEED)
    (rec_name,) = os.listdir(train)
    parsed = [transform_feature(decode_example(r), FEATURE_GROUPS,
                                TAB_CTR_BUCKETS)[1]
              for r in list(Scanner(os.path.join(train, rec_name)))[
                  :TAB_CTR_BATCH]]
    groups = sorted(max_ids, key=lambda n: int(n.split("_")[-1]))
    features = {g: np.stack([f[g] for f in parsed]) for g in groups}
    column = fcol.concatenated_categorical_column(
        [fcol.categorical_column_with_identity(g, max_ids[g])
         for g in groups])
    ids = column(features)
    pad = np.random.RandomState(TAB_SEED).rand(*ids.shape) < TAB_PAD_SHARE
    ids[pad] = embedding_layer.PADDING_ID
    ids[0] = embedding_layer.PADDING_ID  # a row with no ids at all
    gen = torch.Generator(device=device).manual_seed(TAB_SEED)
    report = {"rows": int(column.num_buckets), "dim": TAB_EMB_DIM,
              "ids": list(ids.shape), "padding_slots": int(
                  (ids == embedding_layer.PADDING_ID).sum())}
    errs, launches = [], dict.fromkeys(TAB_KERNELS, 0)
    table = None
    for combiner in ("sum", "mean"):
        _col, factory = fcol.embedding_column(column, TAB_EMB_DIM,
                                              combiner=combiner)
        layer = factory(device=device, generator=gen)
        if table is not None:
            with torch.no_grad():
                layer.embedding_table.copy_(table)
        table = layer.embedding_table.detach()
        ids_dev = torch.as_tensor(ids, device=device)
        _sync(device)
        before = all_launch_counts()
        with torch.no_grad():
            out = layer(ids_dev)
        _sync(device)
        after = all_launch_counts()
        for k in TAB_KERNELS:
            launches[k] += after[k] - before[k]
        plain = factory(device="cpu")
        plain.load_state_dict({"embedding_table": table.cpu()})
        with torch.no_grad():
            ref = plain(torch.as_tensor(ids))
        got = out.cpu()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        check(err <= TAB_EMB_TOL_REL * scale,
              "embedding_column (%s) on %s: max abs err %.3g against the "
              "plain version (largest value %.3g)" % (combiner, device, err,
                                                      scale))
        check(not got[0].any(), "a row of only PADDING_ID gave no zeros")
        report["max_abs_err_" + combiner] = err
        errs.append(err)
        del layer, plain, out
    if device == "cuda":
        check(launches["embedding_gather_many"] == 2
              and launches["embedding_gather"] == 0,
              "the embedding_column lookups launched %s, not kernel E once "
              "a lookup (through embedding_gather_many)" % launches)
        # E alone at the path's shape: the gather of the [batch, 38] ids
        # from the 5.50 M x 8 table, beside its plain version and
        # F.embedding (a library gather of the same rows)
        ids_dev = torch.as_tensor(ids, device=device)
        n = ids_dev.numel()
        ms, _eager = timed_ms(lambda: eo.embedding_gather(table, ids_dev))
        plain_ms, _ = timed_ms(lambda: eo.embedding_gather_plain(table,
                                                                 ids_dev))
        clipped = ids_dev.clamp(0, table.shape[0] - 1)
        library_ms, _ = timed_ms(lambda: F.embedding(clipped, table))
        bound, bound_by = bound_ms(0, n * 8 + 2 * n * TAB_EMB_DIM * 4,
                                   peak=PEAK_FP32_FLOPS)
        report["gather_timing"] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "F.embedding on clamped ids",
            "bound_ms": bound, "bound_by": bound_by}
    del table
    return report, launches, errs


def tabular_zoo_phase(workdir, device="cuda"):
    """Phase 31: the preprocessing layers and the tabular and CTR zoo on
    `device` (see the module docstring). Returns (report, E's launches
    by wrapper, E's errors against its plain version)."""
    t_phase = time.perf_counter()
    out = {"models": {}}
    reset_all_launch_counts()
    for name in TAB_MODELS:
        t0 = time.perf_counter()
        out["models"][name] = rep = _tab_train(name, workdir, device)
        rep["model_s"] = time.perf_counter() - t0
        log("tabular_zoo %s: %s" % (name, json.dumps(rep)))
    # the zoo's tables are plain lookups, as the JAX zoo's flax nn.Embed:
    # training them launches none of the port's kernels
    out["kernel_launches_training"] = all_launch_counts()
    check(not any(out["kernel_launches_training"].values()),
          "the zoo's training launched %s" % out["kernel_launches_training"])
    reset_all_launch_counts()
    out["embedding_column"], launches, errs = _tab_embedding_column(
        workdir, device)
    log("tabular_zoo embedding_column: %s; launches %s" % (
        json.dumps(out["embedding_column"]), launches))
    out["minibatch"] = {
        "tabular": TAB_BATCH, "ctr": TAB_CTR_BATCH,
        "why": ("tabular: heart's published table has 303 rows and "
                "census-income 32,561, so 64 gives each model several "
                "steps of real batches; CTR: the order Criteo CTR models "
                "train at, halved from the DLRM phase's 4096 so the host's "
                "per-record md5 transform keeps the phase near 90 s")}
    out["loss_tol_rel"] = TAB_LOSS_TOL_REL
    out["embedding_tol_rel"] = TAB_EMB_TOL_REL
    out["seconds"] = time.perf_counter() - t_phase
    return out, launches, errs


VIS_SEED = 32
VIS_STEPS = 4  # LocalExecutor steps a model takes
VIS_BATCH = 64  # the README quickstart's minibatch
VIS_CKPT_STEP = 2  # the checkpoint a fresh state restores
VIS_IMAGENET_SIZE = 224  # the published ImageNet crop
# the first loss and the running averages after the first step, card
# against the CPU port from the same weights and batch (BatchNorm in
# training mode, dropout at rate 0, TF32 off): looser than the tabular
# zoo's, as the convs sum kh * kw * in products in other orders through
# up to 53 layers; the running averages are held per buffer to its
# largest value
VIS_LOSS_TOL_REL = 1e-4
VIS_STATS_TOL_REL = 1e-3
# a restored state's eval logits against the saved state's (one device,
# one process, the same weights): bit for bit is expected, this bounds it
VIS_RESTORE_TOL_REL = 1e-6
VIS_QUICKSTART_RECORDS = 256  # records a file, 2 files (the README's)
VIS_QUICKSTART_WAIT_S = 300
# name -> (--model_def in the zoo, generator, its keyword arguments)
VIS_MODELS = {
    "mnist_functional_api": (
        "mnist_functional_api.mnist_functional_api.custom_model",
        "gen_mnist_like", {}),
    "mnist_subclass": ("mnist_subclass.mnist_subclass.custom_model",
                       "gen_mnist_like", {}),
    "cifar10_functional_api": (
        "cifar10_functional_api.cifar10_functional_api.custom_model",
        "gen_cifar10_like", {}),
    "cifar10_subclass": ("cifar10_subclass.cifar10_subclass.custom_model",
                         "gen_cifar10_like", {}),
    "resnet50_subclass": (
        "resnet50_subclass.resnet50_subclass.custom_model",
        "gen_cifar10_like", {}),
    "imagenet_resnet50": (
        "imagenet_resnet50.imagenet_resnet50.custom_model",
        "gen_imagenet_like", {"num_classes": 1000}),
}


def _vis_records(gen, gen_kwargs, workdir):
    """The training (VIS_STEPS batches) and validation (one batch)
    record dirs of a generator, written once."""
    train = os.path.join(workdir, "%s-train" % gen)
    valid = os.path.join(workdir, "%s-valid" % gen)
    kwargs = dict(gen_kwargs)
    if gen == "gen_imagenet_like":
        kwargs["image_size"] = VIS_IMAGENET_SIZE
    if not os.path.isdir(train):
        make = getattr(port_recordio_gen, gen)
        make(train, num_files=1, records_per_file=VIS_BATCH * VIS_STEPS,
             seed=VIS_SEED, **kwargs)
        make(valid, num_files=1, records_per_file=VIS_BATCH,
             seed=VIS_SEED + 1, **kwargs)
    return train, valid


def _vis_dropout_rates(model, rates=None):
    """Set every Dropout of `model` to `rates` (0 when None); returns the
    rates it had."""
    layers = [m for m in model.modules() if isinstance(m, vis_layers.Dropout)]
    before = [m.rate for m in layers]
    for i, m in enumerate(layers):
        m.rate = 0.0 if rates is None else rates[i]
    return before


def _vis_stats_err(got, want):
    """The largest |got - want| of each running-average buffer over its
    largest |want|, the worst of them."""
    worst = 0.0
    for key, ref in want.items():
        scale = max(float(ref.abs().max()), 1e-12)
        worst = max(worst, float((got[key] - ref).abs().max()) / scale)
    return worst


def _vis_train(name, workdir, device):
    """VIS_STEPS LocalExecutor steps (the first at dropout rate 0, the
    rest with dropout on) and one evaluation of one vision model on
    `device`, a checkpoint every VIS_CKPT_STEP steps; then version
    VIS_CKPT_STEP restored into a fresh Trainer, and the first step again
    on the CPU port from the same weights and batch. Returns the model's
    report."""
    model_def, gen, gen_kwargs = VIS_MODELS[name]
    train, valid = _vis_records(gen, gen_kwargs, workdir)
    spec = get_model_spec(_tab_zoo_dir(), model_def)
    ckpt = os.path.join(workdir, name + "-ckpt")
    executor = LocalExecutor(
        spec, training_data=train, validation_data=valid,
        minibatch_size=VIS_BATCH, records_per_task=VIS_BATCH * VIS_STEPS,
        checkpoint_dir=ckpt, checkpoint_steps=VIS_CKPT_STEP, device=device)
    trainer = executor.trainer
    init = {k: v.detach().to("cpu", copy=True)
            for k, v in trainer.model.state_dict().items()}
    param_bytes = sum(p.numel() * p.element_size()
                      for p in trainer.model.parameters())
    stats_bytes = sum(b.numel() * b.element_size()
                      for b in trainer.model.buffers())
    steps, first, saved = [], {}, {}
    step_fn = trainer.train_step

    def recorded(state, batch_, true_count=None):
        rates = None
        if not first:
            first.update(features={k: np.array(v) for k, v in
                                   batch_[0].items()},
                         labels=np.array(batch_[1]), true_count=true_count)
            rates = _vis_dropout_rates(trainer.model)
        _sync(device)
        t0 = time.perf_counter()
        out = step_fn(state, batch_, true_count)
        _sync(device)
        steps.append((time.perf_counter() - t0) * 1e3)
        if rates is not None:
            _vis_dropout_rates(trainer.model, rates)
            first["stats"] = {k: b.detach().to("cpu", copy=True)
                              for k, b in out[0].model_state.items()}
        if out[0].step == VIS_CKPT_STEP:
            saved["flat"] = flatten_state(trainer, out[0])
            saved["logits"] = trainer.forward(
                out[0], first["features"]).detach().to("cpu", copy=True)
        return out

    trainer.train_step = recorded
    base = None
    if device == "cuda":
        torch.cuda.synchronize()
        base = int(torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
    state, metrics = executor.train()
    peak = (int(torch.cuda.max_memory_allocated()) - base
            if device == "cuda" else None)
    losses = list(executor.losses)
    check(state is not None and state.step == VIS_STEPS
          and len(losses) == VIS_STEPS,
          "%s took %d steps, not %d" % (name, len(losses), VIS_STEPS))
    check(all(math.isfinite(x) for x in losses),
          "%s: a non-finite loss in %s" % (name, losses))
    check(sorted(metrics) == ["accuracy"]
          and 0.0 <= metrics["accuracy"] <= 1.0,
          "%s evaluation metrics %s" % (name, metrics))
    on_device = {p.device.type for p in trainer.model.parameters()}
    on_device |= {b.device.type for b in state.model_state.values()}
    check(on_device == {torch.device(device).type},
          "%s's parameters and buffers lie on %s" % (name, sorted(on_device)))
    check(len(state.model_state) > 0 and all(
        not torch.equal(b.cpu(), init[k]) for k, b in
        state.model_state.items()),
          "%s: a running average did not move" % name)
    del trainer.train_step  # the wrapper's reference cycle (see phase 31)
    del executor, trainer, state, step_fn, recorded
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    # version VIS_CKPT_STEP into a fresh Trainer of another seed: every
    # leaf bit for bit, then its eval logits against the saved state's
    t0 = time.perf_counter()
    fresh = Trainer(spec, device=device, seed=1)
    fresh_state = fresh.init_state(None)
    fresh_state, version = restore_state_from_checkpoint(
        fresh, fresh_state, ckpt, version=VIS_CKPT_STEP)
    restore_s = time.perf_counter() - t0
    flat = flatten_state(fresh, fresh_state)
    check(version == VIS_CKPT_STEP and list(flat) == list(saved["flat"]),
          "%s: version %d restored %d leaves, %d saved" % (
              name, version, len(flat), len(saved["flat"])))
    differ = [k for k, v in flat.items()
              if not np.array_equal(np.asarray(v),
                                    np.asarray(saved["flat"][k]))]
    check(not differ, "%s: %d leaves differ after the restore, e.g. %s"
          % (name, len(differ), differ[:3]))
    leaves = {kind: sum(1 for k in flat if k.startswith(prefix))
              for kind, prefix in (("params", ".params"),
                                   ("batch_stats", ".model_state"),
                                   ("opt_state", ".opt_state"))}
    logits = fresh.forward(fresh_state, first["features"]).detach().cpu()
    logit_err = float((logits - saved["logits"]).abs().max())
    logit_scale = float(saved["logits"].abs().max())
    check(logit_err <= VIS_RESTORE_TOL_REL * logit_scale,
          "%s: the restored state's eval logits are %.3g from the saved "
          "state's (largest %.3g)" % (name, logit_err, logit_scale))
    del fresh, fresh_state, flat, saved
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    # the first step again on the CPU port, from the same weights and
    # batch, dropout at rate 0
    t0 = time.perf_counter()
    cpu = Trainer(spec, device="cpu")
    cpu_state = cpu.init_state(None, params=init)
    _vis_dropout_rates(cpu.model)
    cpu_state, cpu_loss = cpu.train_step(
        cpu_state, (first["features"], first["labels"]), first["true_count"])
    cpu_s = time.perf_counter() - t0
    rel = abs(losses[0] - cpu_loss) / max(abs(cpu_loss), 1e-12)
    check(rel <= VIS_LOSS_TOL_REL,
          "%s: first loss %.8f on %s, %.8f on the CPU (rel %.3g > %g)"
          % (name, losses[0], device, cpu_loss, rel, VIS_LOSS_TOL_REL))
    stats_rel = _vis_stats_err(first["stats"], {
        k: b.detach() for k, b in cpu_state.model_state.items()})
    check(stats_rel <= VIS_STATS_TOL_REL,
          "%s: running averages after the first step %.3g from the CPU "
          "port's (> %g)" % (name, stats_rel, VIS_STATS_TOL_REL))
    del cpu, cpu_state, init
    gc.collect()
    return {
        "model_def": model_def, "minibatch": VIS_BATCH, "steps": VIS_STEPS,
        "image": list(first["features"]["image"].shape[1:]),
        "losses": losses, "first_step_dropout_rate": 0.0,
        "first_loss_cpu": cpu_loss, "first_loss_rel_err": rel,
        "running_stats_rel_err": stats_rel, "eval": metrics,
        "param_bytes": int(param_bytes), "batch_stats_bytes": int(stats_bytes),
        "peak_memory_above_baseline_bytes": peak,
        "memory_allocated_before_bytes": base,
        "step_ms": steps, "step_p50_ms": float(np.median(steps)),
        "dataset_fn_records_per_s": _tab_host_rate(spec, train, VIS_BATCH),
        "checkpoint_restore": {
            "version": VIS_CKPT_STEP, "leaves": leaves,
            "leaves_bit_for_bit": True, "restore_s": restore_s,
            "eval_logits_max_abs_diff": logit_err,
            "eval_logits_equal": logit_err == 0.0},
        "cpu_step_s": cpu_s,
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32},
    }


def start_quickstart(device, workdir=None):
    """Start the README's quickstart on the port (the script starts it
    early, beside the kernel checks: a job with no timed section): MNIST
    records from gen_mnist_like (2 files of VIS_QUICKSTART_RECORDS), then
    `client.main train` of mnist_functional_api with 2 worker processes
    sharing the card at minibatch 64. Returns its handle for
    _vis_quickstart."""
    owned = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="quickstart_")
    data = os.path.join(workdir, "quickstart_mnist")
    port_recordio_gen.gen_mnist_like(data, 2, VIS_QUICKSTART_RECORDS)
    status = os.path.join(workdir, "quickstart_status.json")
    cmd = [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train",
           "--model_zoo", _tab_zoo_dir(),
           "--model_def",
           "mnist_functional_api.mnist_functional_api.custom_model",
           "--training_data", data, "--num_workers", "2",
           "--minibatch_size", "64", "--port", "0",
           "--job_status_file", status]
    if device != "cuda":
        cmd += ["--device", device]
    out_log = os.path.join(workdir, "quickstart.log")
    t0 = time.perf_counter()
    with open(out_log, "w") as log_f:
        # a session of its own: closing it kills its workers with it
        proc = subprocess.Popen(cmd, stdout=log_f, stderr=subprocess.STDOUT,
                                env=_mw_env(), cwd=workdir,
                                start_new_session=True)
    handle = {"proc": proc, "t0": t0, "log": out_log, "status": status,
              "cmd": cmd, "workdir": workdir if owned else None}

    def stamp_exit():
        proc.wait()
        handle["t_end"] = time.perf_counter()

    threading.Thread(target=stamp_exit, daemon=True).start()
    return handle


def close_job(handle):
    """Kill a job (the quickstart or the iris job) still running, its
    workers with it, and remove its own directory."""
    proc = handle["proc"]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    if handle["workdir"]:
        shutil.rmtree(handle["workdir"], ignore_errors=True)


def _vis_quickstart(handle):
    """Wait for the quickstart `handle` (start_quickstart) and check it:
    rc 0, the job Succeeded, 2 tasks completed. Returns its report; its
    seconds run from its start to its exit."""
    proc, out_log, status, cmd = (handle["proc"], handle["log"],
                                  handle["status"], handle["cmd"])
    try:
        rc = proc.wait(timeout=max(1.0, VIS_QUICKSTART_WAIT_S - (
            time.perf_counter() - handle["t0"])))
    except subprocess.TimeoutExpired:
        rc = None
    seconds = handle.get("t_end", time.perf_counter()) - handle["t0"]
    close_job(dict(handle, workdir=None))
    job = job_status.read_job_status(status) or {}
    with open(out_log, errors="replace") as f:
        text = f.read()
    completed = len(re.findall(r"Task:\d+ completed", text))
    if rc != 0 or job.get("status") != job_status.SUCCEEDED:
        log("vision_zoo quickstart's log tail:\n%s" % _log_tail(out_log))
    check(rc == 0 and job.get("status") == job_status.SUCCEEDED,
          "the README quickstart ended with rc %s, status %s"
          % (rc, job.get("status")))
    check(completed == 2, "the quickstart completed %d tasks, not 2"
          % completed)
    return {"rc": rc, "status": job.get("status"), "seconds": seconds,
            "workers": 2, "records": 2 * VIS_QUICKSTART_RECORDS,
            "tasks_completed": completed, "minibatch": 64,
            "command": " ".join(cmd[1:])}


def vision_zoo_phase(workdir, device="cuda", quickstart=None):
    """Phase 32: the vision zoo with BatchNorm state, dropout and conv
    weights on `device` (see the module docstring), then the README
    quickstart (`quickstart`, start_quickstart's handle, when the script
    started it early; else started here). Returns (report, the kernels'
    launches in it)."""
    t_phase = time.perf_counter()
    out = {"models": {}}
    reset_all_launch_counts()
    for name in VIS_MODELS:
        t0 = time.perf_counter()
        out["models"][name] = rep = _vis_train(name, workdir, device)
        rep["model_s"] = time.perf_counter() - t0
        log("vision_zoo %s: %s" % (name, json.dumps(rep)))
    out["quickstart"] = _vis_quickstart(
        quickstart or start_quickstart(device, workdir))
    log("vision_zoo quickstart: %s" % json.dumps(out["quickstart"]))
    # conv, BatchNorm, pooling and dense layers are XLA ops in the JAX
    # package, cuDNN / aten calls here: none of the port's kernels
    launches = out["kernel_launches"] = all_launch_counts()
    check(not any(launches.values()),
          "the vision zoo launched %s" % launches)
    out["minibatch"] = VIS_BATCH
    out["loss_tol_rel"] = VIS_LOSS_TOL_REL
    out["running_stats_tol_rel"] = VIS_STATS_TOL_REL
    out["restore_logits_tol_rel"] = VIS_RESTORE_TOL_REL
    out["seconds"] = time.perf_counter() - t_phase
    return out, launches


ENC_SEED = 33
ENC_STEPS = 4  # LocalExecutor steps an encoder takes
# name -> (--model_def in the zoo, model_params, minibatch): BERT-base at
# bench.py:756-757 (bf16, seq 512) and ViT-Base at 224 px, patch 14
# (bench.py:423-424, fp32); both head_dim 64
ENC_MODELS = {
    "bert": ("bert.bert.custom_model",
             dict(vocab_size=30522, seq_len=512, embed_dim=768,
                  num_heads=12, num_layers=12, dtype="bf16"), 16),
    "vit": ("vit.vit.custom_model",
            dict(image_size=224, patch_size=14, num_classes=1000,
                 embed_dim=768, num_heads=12, num_layers=12), 64),
}
ENC_COMPARE_LAYERS = 2  # the card-against-CPU step: full width, 2 layers
ENC_COMPARE_BATCH = 2
ENC_PACKED_DOCS = (32, 400)  # document lengths of the packed bert rows
# a packed bf16 row's logits against each of its documents run alone,
# through BERT-base's 12 layers: the key tiles of a document start at
# another offset in the row, so P's bf16 rounding (relative to other
# running maxima) and cuBLAS's splits of taller matrices differ; held
# as the bf16 logits of the card against the CPU are
ENC_PACKED_TOL_REL = LOGIT_TOL_REL
ENC_IRIS_DEF = "odps_iris_dnn_model.odps_iris_dnn_model.custom_model"
ENC_IRIS_ROWS = 48  # rows a CSV file, 2 files
ENC_IRIS_BATCH, ENC_IRIS_TASK, ENC_IRIS_EPOCHS = 16, 32, 2
# the iris losses on the card against the CPU port's from the same
# weights: one fp32 Dense(3) under SGD
ENC_IRIS_LOSS_TOL_REL = 1e-5
ENC_IRIS_WAIT_S = 300
# the kernels timed at each encoder's path shape: (b, h, l, d, dtype)
ENC_KERNEL_SHAPES = {"bert": (16, 12, 512, 64, torch.bfloat16),
                     "vit": (64, 12, 256, 64, torch.float32)}


def _enc_records(name, workdir):
    """The training records of one encoder (ENC_STEPS batches), written
    once: gen_tokens_like at seq_len and the vocabulary, or
    gen_imagenet_like at the image size and class count."""
    _model_def, cfg, batch = ENC_MODELS[name]
    train = os.path.join(workdir, "%s-train" % name)
    n = batch * ENC_STEPS
    if name == "bert":
        port_recordio_gen.gen_tokens_like(
            train, num_files=1, records_per_file=n, seed=ENC_SEED,
            seq_len=cfg["seq_len"], vocab_size=cfg["vocab_size"])
    else:
        port_recordio_gen.gen_imagenet_like(
            train, num_files=1, records_per_file=n, seed=ENC_SEED,
            image_size=cfg["image_size"], num_classes=cfg["num_classes"])
    return train


def _enc_train(name, workdir, device):
    """ENC_STEPS LocalExecutor steps of one encoder at its published
    width on `device` (vit with dropout on), each step's ms and kernel
    launches. Returns (report, executor)."""
    model_def, cfg, batch = ENC_MODELS[name]
    t0 = time.perf_counter()
    train = _enc_records(name, workdir)
    write_s = time.perf_counter() - t0
    spec = get_model_spec(_tab_zoo_dir(), model_def)
    executor = LocalExecutor(
        spec, training_data=train, minibatch_size=batch,
        records_per_task=batch * ENC_STEPS, model_params=_dlrm_params_str(cfg),
        seed=ENC_SEED, device=device)
    trainer = executor.trainer
    steps = []
    step_fn = trainer.train_step

    def timed(state, batch_, true_count=None):
        before = all_launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        out = step_fn(state, batch_, true_count)
        _sync(device)
        after = all_launch_counts()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "launches": {k: after[k] - before[k] for k in after
                                   if after[k] != before[k]}})
        return out

    trainer.train_step = timed
    base = None
    if device == "cuda":
        torch.cuda.synchronize()
        base = int(torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _metrics = executor.train()
    wall = time.perf_counter() - t0
    peak = (int(torch.cuda.max_memory_allocated()) - base
            if device == "cuda" else None)
    del trainer.train_step  # the wrapper's reference cycle (see phase 31)
    losses = list(executor.losses)
    check(state is not None and state.step == ENC_STEPS
          and len(losses) == ENC_STEPS,
          "%s took %d steps, not %d" % (name, len(losses), ENC_STEPS))
    check(all(math.isfinite(x) for x in losses),
          "%s: a non-finite loss in %s" % (name, losses))
    layers = cfg["num_layers"]
    if device == "cuda":
        for i, s in enumerate(steps):
            want = {k: layers for k in TRAINING_KERNELS}
            check(s["launches"] == want,
                  "%s step %d launched %s, not %s" % (name, i, s["launches"],
                                                      want))
    step_ms = [s["ms"] for s in steps]
    p50 = float(np.median(step_ms[1:]))
    unit = "tokens" if name == "bert" else "images"
    per_step = batch * (cfg["seq_len"] if name == "bert" else 1)
    rep = {
        "model_def": model_def, "model_params": _dlrm_params_str(cfg),
        "minibatch": batch, "steps": ENC_STEPS, "losses": losses,
        "step_ms": step_ms, "step_p50_ms": p50,
        "step_p50_over": "steps 2-%d (step 1 warms the card)" % ENC_STEPS,
        "%s_per_s" % unit: per_step / (p50 / 1e3),
        "peak_memory_above_baseline_bytes": peak,
        "memory_allocated_before_bytes": base,
        "param_bytes": int(sum(p.numel() * p.element_size()
                               for p in trainer.model.parameters())),
        "launches_per_step": steps[-1]["launches"],
        "records_write_s": write_s, "train_wall_s": wall,
        "dataset_fn_records_per_s": _tab_host_rate(spec, train, batch),
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32},
    }
    log("encoder_zoo %s: %s" % (name, json.dumps(rep)))
    return rep, executor


def _bert_packed_rows(rng):
    """pack_sequences over documents of ENC_PACKED_DOCS tokens drawn by
    `rng` at BERT-base's vocabulary and seq_len: (tokens, segment_ids,
    labels), at least a minibatch of rows."""
    _model_def, cfg, batch = ENC_MODELS["bert"]
    seq, vocab = cfg["seq_len"], cfg["vocab_size"]
    lo, hi = ENC_PACKED_DOCS
    docs = [rng.randint(0, vocab, size=rng.randint(lo, hi + 1))
            for _ in range(3 * batch * seq // ((lo + hi) // 2) + 1)]
    tokens, seg, labels = packing.pack_sequences(docs, seq)
    check(tokens.shape[0] >= batch, "too few packed rows")
    return tokens, seg, labels


def _enc_packed(executor, rng, device):
    """BERT-base's packed rows on `device` after its training: the row
    of pack_sequences (documents of ENC_PACKED_DOCS tokens) that holds
    the most documents against each document run alone, within
    ENC_PACKED_TOL_REL of the largest logit; then one training step of
    a minibatch of packed rows, masked as dataset_fn masks. Returns
    (report, the training step's launches)."""
    _model_def, cfg, batch = ENC_MODELS["bert"]
    trainer, model = executor.trainer, executor.trainer.model
    vocab = cfg["vocab_size"]
    tokens, seg, labels = _bert_packed_rows(rng)
    r = int(np.argmax(docs_per_row(seg, labels)))
    dev = model.device
    worst, n_docs = 0.0, 0
    with torch.no_grad():
        packed = model({"tokens": torch.as_tensor(tokens[r:r + 1],
                                                  device=dev),
                        "segment_ids": torch.as_tensor(seg[r:r + 1],
                                                       device=dev)})
        for sid in np.unique(seg[r]):
            span = np.flatnonzero(seg[r] == sid)
            if not (labels[r][span] != packing.IGNORE_LABEL).any():
                continue  # the pad tail
            alone = model({"tokens": torch.as_tensor(
                tokens[r:r + 1, span], device=dev)})
            worst = max(worst, rel_err(packed[0, span[0]:span[-1] + 1],
                                       alone[0]))
            n_docs += 1
    log("bert packed row vs its %d documents alone (%s, %d layers): rel "
        "err %.3g" % (n_docs, cfg["dtype"], cfg["num_layers"], worst))
    check(n_docs >= 2, "the packed bert row holds %d documents" % n_docs)
    check(worst <= ENC_PACKED_TOL_REL,
          "a packed bert row's logits differ from its documents' by %.3g "
          "of the largest logit" % worst)
    masked, mlm = zip(*[bert_zoo._mask_tokens(row.astype(np.int32), vocab,
                                              np.random.RandomState(i))
                        for i, row in enumerate(tokens[:batch])])
    features = {"tokens": np.stack(masked),
                "segment_ids": np.asarray(seg[:batch], np.int32)}
    reset_all_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    executor.state, loss = trainer.train_step(
        executor.state, (features, np.stack(mlm)))
    _sync(device)
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in all_launch_counts().items() if v}
    check(math.isfinite(loss), "the packed bert step's loss is %r" % loss)
    if device == "cuda":
        want = {k + "_segments": cfg["num_layers"] for k in TRAINING_KERNELS}
        check(launches == want, "the packed bert step launched %s, not %s"
              % (launches, want))
    rep = {"documents_in_row": n_docs, "logits_max_rel_err": worst,
           "limit_rel": ENC_PACKED_TOL_REL, "train_step_loss": loss,
           "train_step_ms": step_ms, "rows": batch,
           "documents_in_batch": int(docs_per_row(seg[:batch],
                                                  labels[:batch]).sum()),
           "launches": launches}
    log("encoder_zoo bert_packed: %s" % json.dumps(rep))
    return rep, launches


def _enc_compare(name, rng, device):
    """One train_step of a ENC_COMPARE_LAYERS-layer model at the
    encoder's full width on `device` and on the CPU (plain versions),
    from the same weights and batch (vit's dropout at rate 0): the loss
    and every parameter's gradient norm, by relative error
    (STEP_LOSS_TOL_REL, STEP_GRAD_NORM_TOL_REL, as compare_train_step)."""
    model_def, cfg, _batch = ENC_MODELS[name]
    cfg = dict(cfg, num_layers=ENC_COMPARE_LAYERS)
    spec = get_model_spec(_tab_zoo_dir(), model_def)
    params = _dlrm_params_str(cfg)
    init = {k: v.detach().clone() for k, v in spec.create_model(
        params, device="cpu", seed=3).state_dict().items()}
    n = ENC_COMPARE_BATCH
    if name == "bert":
        tokens = rng.randint(0, cfg["vocab_size"], size=(n, cfg["seq_len"]))
        masked, mlm = zip(*[bert_zoo._mask_tokens(
            row.astype(np.int32), cfg["vocab_size"], rng) for row in tokens])
        batch = ({"tokens": np.stack(masked)}, np.stack(mlm))
    else:
        s = cfg["image_size"]
        batch = ({"image": (rng.rand(n, s, s, 3) * 255).astype(np.float32)},
                 rng.randint(cfg["num_classes"], size=n).astype(np.int32))
    runs = {}
    for dev in (device, "cpu"):
        trainer = Trainer(spec, model_params=params, device=dev)
        _vis_dropout_rates(trainer.model)
        state = trainer.init_state(batch, params=init)
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        secs = time.perf_counter() - t0
        runs[dev] = (loss, {k: p.grad.float().norm().item()
                            for k, p in state.params.items()}, secs)
        del trainer, state
    (gl, gn, gs), (cl, cn, cs) = runs[device], runs["cpu"]
    loss_err = abs(gl - cl) / abs(cl)
    norm_errs = {k: abs(gn[k] - cn[k]) / max(cn[k], 1e-30) for k in cn}
    worst = max(norm_errs, key=norm_errs.get)
    log("%s train step %s vs cpu: loss %.6f / %.6f (rel %.3g); worst grad "
        "norm rel err %.3g (%s); %.1f s / %.1f s"
        % (name, device, gl, cl, loss_err, norm_errs[worst], worst, gs, cs))
    check(all(math.isfinite(x) for x in list(gn.values()) + [gl]),
          "%s: non-finite loss or gradient on %s" % (name, device))
    check(loss_err <= STEP_LOSS_TOL_REL,
          "%s train step loss: %s %.6f vs cpu %.6f" % (name, device, gl, cl))
    check(norm_errs[worst] <= STEP_GRAD_NORM_TOL_REL,
          "%s gradient norm of %s: %s %.6g vs cpu %.6g"
          % (name, worst, device, gn[worst], cn[worst]))
    return {"layers": ENC_COMPARE_LAYERS, "minibatch": n,
            "loss_device": gl, "loss_cpu": cl, "loss_rel_err": loss_err,
            "grad_norm_max_rel_err": norm_errs[worst],
            "grad_norm_worst_param": worst,
            "limits": {"loss_rel": STEP_LOSS_TOL_REL,
                       "grad_norm_rel": STEP_GRAD_NORM_TOL_REL},
            "device_s": gs, "cpu_s": cs}


def _iris_data(workdir):
    data = os.path.join(workdir, "iris")
    port_recordio_gen.gen_iris_csv(data, num_files=2,
                                   rows_per_file=ENC_IRIS_ROWS,
                                   seed=ENC_SEED)
    return data


def start_iris_job(device, workdir=None):
    """Start the iris job through `client.main train` with one worker
    process over its own gen_iris_csv files (the script starts it early,
    beside the kernel checks: a job with no timed section). Returns its
    handle for _enc_iris."""
    owned = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="iris_job_")
    data = _iris_data(workdir)
    status = os.path.join(workdir, "iris_status.json")
    cmd = [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train",
           "--model_zoo", _tab_zoo_dir(), "--model_def", ENC_IRIS_DEF,
           "--training_data", data, "--num_workers", "1",
           "--minibatch_size", str(ENC_IRIS_BATCH),
           "--records_per_task", str(ENC_IRIS_TASK), "--port", "0",
           "--job_status_file", status]
    if device != "cuda":
        cmd += ["--device", device]
    out_log = os.path.join(workdir, "iris_job.log")
    t0 = time.perf_counter()
    with open(out_log, "w") as log_f:
        # a session of its own: closing it kills its workers with it
        proc = subprocess.Popen(cmd, stdout=log_f, stderr=subprocess.STDOUT,
                                env=_mw_env(), cwd=workdir,
                                start_new_session=True)
    handle = {"proc": proc, "t0": t0, "log": out_log, "status": status,
              "cmd": cmd, "workdir": workdir if owned else None}

    def stamp_exit():
        proc.wait()
        handle["t_end"] = time.perf_counter()

    threading.Thread(target=stamp_exit, daemon=True).start()
    return handle


def _enc_iris(workdir, device, job=None):
    """odps_iris_dnn_model on CSV rows: gen_iris_csv (2 files of
    ENC_IRIS_ROWS), ENC_IRIS_EPOCHS epochs through LocalExecutor on
    `device` and on the CPU from the same weights (losses within
    ENC_IRIS_LOSS_TOL_REL), then the job through `client.main train`
    with one worker process (`job`, start_iris_job's handle, when the
    script started it early; else started here): rc 0, Succeeded, every
    task completed."""
    data = _iris_data(workdir)
    spec = get_model_spec(_tab_zoo_dir(), ENC_IRIS_DEF)
    init = {k: v.clone() for k, v in spec.create_model(
        "", device="cpu", seed=ENC_SEED).state_dict().items()}
    runs = {}
    for dev in (device, "cpu"):
        random.seed(ENC_SEED)  # the dispatcher's task shuffle
        executor = LocalExecutor(
            spec, training_data=data, minibatch_size=ENC_IRIS_BATCH,
            records_per_task=ENC_IRIS_TASK, num_epochs=ENC_IRIS_EPOCHS,
            device=dev)
        executor.state = executor.trainer.init_state(None, params=init)
        executor.train()
        runs[dev] = list(executor.losses)
    got, want = runs[device], runs["cpu"]
    steps = ENC_IRIS_EPOCHS * 2 * -(-ENC_IRIS_ROWS // ENC_IRIS_BATCH)
    check(len(got) == len(want) == steps,
          "iris took %d and %d steps, not %d" % (len(got), len(want), steps))
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got, want))
    check(rel <= ENC_IRIS_LOSS_TOL_REL,
          "iris losses on %s %s, on the CPU %s (rel %.3g)"
          % (device, got, want, rel))
    job = job or start_iris_job(device, workdir)
    proc, out_log, status, cmd = (job["proc"], job["log"], job["status"],
                                  job["cmd"])
    try:
        rc = proc.wait(timeout=max(1.0, ENC_IRIS_WAIT_S - (
            time.perf_counter() - job["t0"])))
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        close_job(dict(job, workdir=None))
    seconds = job.get("t_end", time.perf_counter()) - job["t0"]
    job = job_status.read_job_status(status) or {}
    with open(out_log, errors="replace") as f:
        completed = len(re.findall(r"Task:\d+ completed", f.read()))
    if rc != 0 or job.get("status") != job_status.SUCCEEDED:
        log("encoder_zoo iris job's log tail:\n%s" % _log_tail(out_log))
    check(rc == 0 and job.get("status") == job_status.SUCCEEDED,
          "the iris CSV job ended with rc %s, status %s"
          % (rc, job.get("status")))
    tasks = 2 * -(-ENC_IRIS_ROWS // ENC_IRIS_TASK)
    check(completed == tasks, "the iris job completed %d tasks, not %d"
          % (completed, tasks))
    rep = {"rows": 2 * ENC_IRIS_ROWS, "losses": got, "losses_cpu": want,
           "loss_max_rel_err": rel, "limit_rel": ENC_IRIS_LOSS_TOL_REL,
           "job": {"rc": rc, "status": job.get("status"),
                   "tasks_completed": completed, "seconds": seconds,
                   "command": " ".join(cmd[1:])}}
    log("encoder_zoo iris: %s" % json.dumps(rep))
    return rep


def encoder_zoo_phase(workdir, device="cuda", iris_job=None):
    """Phase 33: BERT-base and ViT-Base training at full width, the
    card against the CPU port, packed bert rows and the iris model on
    CSV rows (see the module docstring). Returns (report, the kernels'
    launches by part)."""
    t_phase = time.perf_counter()
    rng = np.random.RandomState(ENC_SEED)
    out = {"models": {}}
    launches = {}
    for name in ENC_MODELS:
        reset_all_launch_counts()
        rep, executor = _enc_train(name, workdir, device)
        launches[name] = {k: v for k, v in all_launch_counts().items() if v}
        out["models"][name] = rep
        if name == "bert":
            out["bert_packed"], launches["bert_packed"] = _enc_packed(
                executor, rng, device)
        del executor, rep
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    if device == "cuda":
        for name in ENC_MODELS:
            want = {k: ENC_MODELS[name][1]["num_layers"] * ENC_STEPS
                    for k in TRAINING_KERNELS}
            check(launches[name] == want, "%s's run launched %s, not %s"
                  % (name, launches[name], want))
    out["cuda_vs_cpu_step"] = {name: _enc_compare(name, rng, device)
                               for name in ENC_MODELS}
    gc.collect()
    reset_all_launch_counts()
    out["iris"] = _enc_iris(workdir, device, iris_job)
    launches["iris"] = {k: v for k, v in all_launch_counts().items() if v}
    check(not launches["iris"], "the iris model launched %s"
          % launches["iris"])
    out["kernel_launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out, launches


def time_encoder_kernels(launches):
    """Kernels A, C and D at each encoder's path shape (ENC_KERNEL_SHAPES:
    not causal, d 64; bert bf16, vit fp32), against their plain versions
    (bf16 also against the plain version that rounds as they do); at
    bert's shape also their segments variants on the packed bert step's
    segment ids (_flash_case's limits, those of check_masked_flash); then
    timed beside their bound (bf16 peak for bert, fp32 peak for vit),
    the plain version, SDPA (A) and aten's flash or memory-efficient
    backward (C + D). `launches`: encoder_zoo_phase's, by part."""
    gen = torch.Generator().manual_seed(ENC_SEED)
    entries = []
    for family, (b, h, l, d, dtype) in ENC_KERNEL_SHAPES.items():
        q, k, v = flash_inputs(gen, b, h, h, l, d, dtype)
        do = flash_inputs(gen, b, h, h, l, d, dtype)[0]
        out, lse = att.flash_forward(q, k, v, causal=False)
        dq, delta = att.flash_backward_dq(q, k, v, out, lse, do,
                                          causal=False)
        dk, dv = att.flash_backward_dkv(q, k, v, do, lse, delta,
                                        causal=False)
        torch.cuda.synchronize()
        fwd_err = flash_fwd_errs(q, k, v, out, lse, False, {})
        check(fwd_ok(fwd_err), "flash_fwd disagrees with its plain version "
              "at %s's shape: %s" % (family, fwd_err))
        pdq, pdelta = att.flash_backward_dq_plain(q, k, v, out, lse, do,
                                                  causal=False)
        pdk, pdv = att.flash_backward_dkv_plain(q, k, v, do, lse, pdelta,
                                                causal=False)
        bwd_err = {}
        for name, pairs in (("flash_bwd_dq", ((dq, pdq), (delta, pdelta))),
                            ("flash_bwd_dkv", ((dk, pdk), (dv, pdv)))):
            rel = max(rel_err(a.float(), b_.float()) for a, b_ in pairs)
            bwd_err[name] = {
                "max_abs_err": max((a.float() - b_.float()).abs().max().item()
                                   for a, b_ in pairs),
                "max_rel_err": rel}
            check(rel <= BWD_TOL_REL[dtype], "%s disagrees with its plain "
                  "version at %s's shape: rel err %.3g" % (name, family, rel))
        if dtype == torch.bfloat16:
            for name, e in rounded_bwd_errs(q, k, v, out, lse, do,
                                            causal=False).items():
                check(rounded_ok(e), "%s disagrees with its rounded plain "
                      "version at %s's shape: %s" % (name, family, e))
                bwd_err[name].update({"rounded_" + key: val
                                      for key, val in e.items()})
        log("encoder kernels at %s's shape: fwd %s, bwd %s"
            % (family, fwd_err, bwd_err))
        seg_errs = None
        if family == "bert":
            # the segments variants on the packed bert step's segment ids
            # (encoder_zoo_phase draws them from the same seed)
            seg = torch.as_tensor(_bert_packed_rows(
                np.random.RandomState(ENC_SEED))[1][:b]).cuda()
            seg_errs, variant = _flash_case(q, k, v, do, False,
                                            {"q_seg": seg, "k_seg": seg})
            _check_flash_errs(seg_errs, variant, dtype,
                              "bert's packed path shape")
            log("encoder kernels%s at bert's packed path shape: %s"
                % (variant, seg_errs))
        itemsize = torch.tensor([], dtype=dtype).element_size()
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
        shape = "b=%d h=%d lq=lk=%d d=%d not causal %s (%s's path)" % (
            b, h, l, d, str(dtype)[6:], family)
        path = {name + "_" + family: launches[family][name]
                for name in TRAINING_KERNELS}
        library = sdpa_backward_ms(q, k, v, do, causal=False)
        fwd = _timing_entry(
            "flash_fwd_" + family, "elasticdl_tpu_torch/csrc/flash_fwd.cu",
            "elasticdl_tpu/ops/attention.py:941", shape,
            lambda: att.flash_forward(q, k, v, causal=False),
            lambda: att.flash_attention_plain(q, k, v, causal=False,
                                              bf16_operands=True),
            lambda: F.scaled_dot_product_attention(q, k, v),
            flash_work(b, h, h, l, l, d, itemsize, causal=False), path,
            dict(fwd_err, max_err=fwd_err["max_abs_err"]), peak=peak)
        entries.append(fwd)
        for name, line, fn, plain, dkv in (
                ("flash_bwd_dq", 1241,
                 lambda: att.flash_backward_dq(q, k, v, out, lse, do,
                                               causal=False),
                 lambda: att.flash_backward_dq_plain(q, k, v, out, lse, do,
                                                     causal=False), False),
                ("flash_bwd_dkv", 1294,
                 lambda: att.flash_backward_dkv(q, k, v, do, lse, delta,
                                                causal=False),
                 lambda: att.flash_backward_dkv_plain(q, k, v, do, lse, delta,
                                                      causal=False), True)):
            entries.append(_timing_entry(
                name + "_" + family, "elasticdl_tpu_torch/csrc/flash_bwd.cu",
                "elasticdl_tpu/ops/attention.py:%d" % line, shape, fn, plain,
                library, flash_bwd_work(b, h, h, l, d, itemsize, dkv,
                                        causal=False), path,
                dict(bwd_err[name], max_err=bwd_err[name]["max_abs_err"]),
                peak=peak))
        for entry in entries[-3:]:
            entry["launches_per_step"] = entry["launches"] // ENC_STEPS
            if seg_errs is not None:
                kernel = entry["name"][:-len(family) - 1]
                entry["segments_check"] = dict(
                    seg_errs[kernel], variant=kernel + "_segments",
                    segment_ids="the packed bert step's (pack_sequences "
                    "over documents of %d-%d tokens)" % ENC_PACKED_DOCS)
        del q, k, v, do, out, lse, dq, delta, dk, dv, pdq, pdelta, pdk, pdv
        torch.cuda.empty_cache()
    return entries


MP_SLOTS = 8  # the flagship serving configuration's (bench.py)
MP_TIGHT_DEADLINE_MS = (100, 150, 200, 250)  # sent behind the specs
MP_TIGHT_NEW = 64  # more tokens than such a deadline can decode
MP_LATE_DEADLINE_MS = (1000, 2000, 4000, 8000)  # after the first scrape
MP_LATE_NEW = 16
MP_SCRAPES, MP_INTERVAL_S = 3, 2.0
MP_COLLECTOR_INTERVAL_S = 1.0  # the collector CLI's scrapes, 2 of them
MP_SETTLE_S = 10.0  # bound on the router's heartbeat catching up
MP_SCRAPE_EVERY_S = 0.1  # (a)'s scraper: 150x Prometheus's usual 15 s
MP_RENDERS = 50  # renders of (a)'s last families timed after the pass
MP_WAIT_S = 300


def _mp_scraper(server, out, stop):
    """Scrape `server`'s /metrics every MP_SCRAPE_EVERY_S until `stop`,
    keeping each page and its round trip's seconds (the pages are
    parsed after the pass, off its host threads)."""
    url = "http://127.0.0.1:%d/metrics" % server.metrics.port
    while not stop.is_set():
        t0 = time.perf_counter()
        out["pages"].append(urllib.request.urlopen(url, timeout=60).read()
                            .decode())
        out["scrape"].append(time.perf_counter() - t0)
        stop.wait(MP_SCRAPE_EVERY_S)


def _mp_pass(model, specs, plane_on, device):
    """Phase 34 (a): the specs through an in-process replica at the
    flagship's serving configuration, admitted while the scheduler waits
    on a held job (_tiers_pass), with the plane off (forensics off, no
    metrics port) or on (forensics on, /metrics on an ephemeral port
    scraped from another thread throughout)."""
    server = GenerationServer(model, ServingConfig(
        num_slots=MP_SLOTS, queue_capacity=64, kv_paged=True,
        kv_block_size=16, kv_shared=True, forensics=plane_on,
        metrics_port=0 if plane_on else None)).start()
    scrapes, stop = {"scrape": [], "pages": []}, threading.Event()
    scraper = None
    try:
        server.generate([1, 2, 3, 4], 2)  # warm, outside the counts
        server.telemetry.reset_latency()  # as the entry's warmup does
        _sync(device)
        att.reset_launch_counts()
        if plane_on:
            scraper = threading.Thread(target=_mp_scraper,
                                       args=(server, scrapes, stop),
                                       daemon=True)
            scraper.start()
        reqs, times = _tiers_pass(server, specs)
        _sync(device)
        launches = {n: att.KERNEL_LAUNCHES[n] for n in SERVING_KERNELS}
        stop.set()
        if scraper is not None:
            scraper.join(timeout=60)
            check(not scraper.is_alive() and scrapes["scrape"],
                  "the /metrics scraper did not finish: %r" % scrapes)
        tokens = sum(len(r.generated) for r in reqs)
        exemplars = {ex[0] for ex in
                     server.telemetry.hists["ttft_ms"].exemplars.values()}
        traces = {r.trace_id for r in reqs}
        out = dict(times, tokens=tokens,
                   decode_tokens_per_s=tokens / times["wall_s"],
                   ttft_exemplars=len(exemplars))
        check(all(r.span is not None and r.span.status == "ok"
                  for r in reqs), "a request's serve span is not ok")
        if plane_on:
            check(exemplars and exemplars <= traces, "the TTFT exemplars "
                  "%s name no request of the pass" % sorted(exemplars))
            fams = [parse_prometheus_text(text) for text in scrapes["pages"]]
            last = server._metrics_families()
            renders = []
            for _ in range(MP_RENDERS):
                t0 = time.perf_counter()
                render_prometheus(last)
                renders.append(time.perf_counter() - t0)
            out.update(scrapes=len(scrapes["scrape"]),
                       scrape_ms=_pcts(scrapes["scrape"]),
                       render_ms=_pcts(renders),
                       page_families=len(fams[-1]),
                       page_bytes=len(scrapes["pages"][-1]))
        else:
            check(not exemplars, "exemplars with the plane off")
    finally:
        stop.set()
        server.stop(timeout=120)
    check(server.scheduler.crashed is None,
          "scheduler crashed: %r" % (server.scheduler.crashed,))
    return [list(r.generated) for r in reqs], launches, out


def _crc32c_bitwise(data):
    """CRC32C bit by bit, with no table: it shares no code with the event
    writer (common/tb_events.py) whose files it checks."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
    return crc ^ 0xFFFFFFFF


def _masked_crc32c(data):
    crc = _crc32c_bitwise(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _pb_fields(buf):
    """[(field number, value)] of one protobuf message level."""
    out, off = [], 0

    def varint(off):
        val = shift = 0
        while True:
            b = buf[off]
            off += 1
            val |= (b & 0x7F) << shift
            if not b & 0x80:
                return val, off
            shift += 7

    while off < len(buf):
        key, off = varint(off)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, off = varint(off)
        elif wire == 1:
            val, off = struct.unpack_from("<d", buf, off)[0], off + 8
        elif wire == 5:
            val, off = struct.unpack_from("<f", buf, off)[0], off + 4
        elif wire == 2:
            n, off = varint(off)
            val, off = buf[off:off + n], off + n
        else:
            raise SmokeFailure("event file: wire type %d" % wire)
        out.append((num, val))
    return out


def read_event_file(path):
    """The scalars of a TensorBoard event file as [(step, tag, value)],
    both masked CRCs of every record checked and the header event
    required first; any fault fails the run."""
    with open(path, "rb") as f:
        blob = f.read()
    off, out, header = 0, [], None
    while off < len(blob):
        check(off + 12 <= len(blob), "%s: a torn record header" % path)
        (n,) = struct.unpack_from("<Q", blob, off)
        check(off + 16 + n <= len(blob), "%s: a torn record" % path)
        payload = blob[off + 12:off + 12 + n]
        check(struct.unpack_from("<I", blob, off + 8)[0]
              == _masked_crc32c(blob[off:off + 8])
              and struct.unpack_from("<I", blob, off + 12 + n)[0]
              == _masked_crc32c(payload), "%s: a CRC fails at byte %d"
              % (path, off))
        off += 16 + n
        step = 0
        for num, val in _pb_fields(payload):
            if num == 2:
                step = val - (1 << 64) if val >= 1 << 63 else val
            elif num == 3:
                header = bytes(val)
            elif num == 5:
                for _n, sval in _pb_fields(val):
                    fields = dict(_pb_fields(sval))
                    out.append((step, bytes(fields[1]).decode("utf-8"),
                                fields[2]))
    check(header == b"brain.Event:2", "%s: no file-version header" % path)
    return out


def _last_scalars(path, prefix, names):
    """{name: the last `<prefix><name>_total` scalar} of an event file."""
    last = {}
    for _step, tag, value in read_event_file(path):
        last[tag] = value
    return {name: last.get("%s%s_total" % (prefix, name)) for name in names}


def _event_file(directory, suffix=""):
    files = glob.glob(os.path.join(directory, "events.out.tfevents.*"))
    check(len(files) == 1 and files[0].endswith(suffix), "%s holds the "
          "event files %s, not one *%s" % (directory, files, suffix))
    return files[0]


def _mp_get(port):
    return urllib.request.urlopen("http://127.0.0.1:%d/metrics" % port,
                                  timeout=60).read().decode()


def _mp_value(fams, name, labels=None):
    """A sample's value on a parsed page (0 when absent)."""
    for sample_name, lab, value in fams.get(name, {}).get("samples", ()):
        if sample_name == name and lab == (labels or {}):
            return value
    return 0


def _mp_metrics_port(child):
    line = child.line("METRICS_READY")
    return int(re.match(r"\d+", line.split("port=")[1]).group())


def _mp_load(stub, specs):
    """Phase 34 (b)'s load: a sleep hook for scrape_fleet whose first
    call sends the specs and, behind them, the tight-deadline requests,
    and whose second sends the late ones; each call on a thread of its
    own. Returns (hook, the results by trace, the threads)."""
    results, threads, calls = {}, [], [0]

    def send(trace, prompt, new, deadline_ms):
        method = ("router_generate" if len(results) % 3 == 1 else
                  "router_generate_stream")
        results[trace] = {}
        t = threading.Thread(target=_routed, args=(
            stub, method, trace, prompt, new, results[trace]),
            kwargs={"deadline_ms": deadline_ms}, daemon=True)
        t.start()
        threads.append(t)

    def hook(secs):
        t0 = time.monotonic()
        calls[0] += 1
        if calls[0] == 1:
            for i, (prompt, new) in enumerate(specs):
                send("mp-spec-%02d" % i, prompt, new, 0)
            time.sleep(0.1)  # the tight ones queue behind them
            for i, deadline in enumerate(MP_TIGHT_DEADLINE_MS):
                send("mp-tight-%d" % i, specs[i][0], MP_TIGHT_NEW, deadline)
        else:
            for i, deadline in enumerate(MP_LATE_DEADLINE_MS):
                send("mp-late-%d" % i, specs[-1 - i][0], MP_LATE_NEW,
                     deadline)
        time.sleep(max(0.0, secs - (time.monotonic() - t0)))

    return hook, results, threads


def _mp_fleet(specs, trace_dir, children):
    """Phase 34 (b): two replica processes (`children`, started by the
    caller) behind a router process, all with /metrics and
    EDL_TRACE_DIR; the load while scrape_fleet scrapes the router; the
    counters, buckets and exemplars across pages and status RPCs; the
    collector CLI against the live router; SIGTERM; the incident report
    and the dump. The processes it starts join `children`."""
    out, replicas = {}, list(children)
    env = {"EDL_TRACE_DIR": trace_dir}
    for rep in replicas:
        rep.ready("SERVING_READY")
    out["replica_ready_s"] = [rep.ready_s for rep in replicas]
    rep_mports = [_mp_metrics_port(rep) for rep in replicas]
    addrs = ["localhost:%d" % rep.port for rep in replicas]
    argv = [sys.executable, "-m", "elasticdl_tpu_torch.serving.router_main",
            "--port", "0", "--metrics_port", "0", "--tensorboard_log_dir",
            _mp_tb_dir(trace_dir, "router")]
    for addr in addrs:
        argv += ["--replica", addr]
    router = _Child(argv, "the metrics router", extra_env=env)
    children.append(router)  # closed by the caller
    router.ready("ROUTER_READY")
    r_mport = _mp_metrics_port(router)
    out["router_ready_s"] = router.ready_s
    stub = wire_service.RouterStub(wire_service.build_channel(
        "localhost:%d" % router.port))
    _wait_polled(stub, 2, "the metrics router")
    hook, results, threads = _mp_load(stub, specs)
    sent = len(specs) + len(MP_TIGHT_DEADLINE_MS) + len(MP_LATE_DEADLINE_MS)
    t0 = time.perf_counter()
    bundle = collector.scrape_fleet(["127.0.0.1:%d" % r_mport],
                                    scrapes=MP_SCRAPES,
                                    interval_secs=MP_INTERVAL_S, sleep=hook)
    for t in threads:
        t.join(timeout=MP_WAIT_S)
        check(not t.is_alive(), "a routed call did not end")
    out["load_s"] = time.perf_counter() - t0
    check(len(results) == sent, "%d calls sent, %d wanted"
          % (len(results), sent))
    codes = {}
    for trace, r in results.items():
        key = r["code"] or "OK"
        codes[key] = codes.get(key, 0) + 1
        if not trace.startswith("mp-tight") and r["code"] is None:
            check(r["done"], "%s ended without done" % trace)
    out["outcomes"] = codes
    check(set(codes) <= {"OK", "DEADLINE_EXCEEDED"}, "unexpected outcomes "
          "%s" % codes)
    check(codes.get("DEADLINE_EXCEEDED", 0) >= 1, "no tight request "
          "expired: %s" % codes)
    # the replicas' pages against their status RPCs, the router's fleet
    # TTFT buckets against the replicas' summed ones after a heartbeat
    direct = [wire_service.ServingStub(wire_service.build_channel(a))
              for a in addrs]
    deadline = time.monotonic() + MP_SETTLE_S
    while True:
        rep_pages = [parse_prometheus_text(_mp_get(p)) for p in rep_mports]
        summed = []
        for fams in rep_pages:
            counts, _ex = collector._counts_from_hist_family(
                fams["edl_serving_ttft_ms"])
            summed = add_counts(summed, counts)
        r_page = parse_prometheus_text(_mp_get(r_mport))
        fleet, _ex = collector._counts_from_hist_family(
            r_page["edl_router_fleet_ttft_ms"])
        if fleet == summed or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    check(fleet == summed and sum(fleet) > 0, "the router's fleet TTFT "
          "buckets %s, the replicas' summed %s" % (fleet, summed))
    rst = stub.router_status(wire_pb.RouterStatusRequest(), timeout=60)
    for name in ("routed", "completed", "shed", "redispatched", "hedges",
                 "breaker_trips", "affinity_hits", "affinity_misses"):
        check(_mp_value(r_page, "edl_router_%s_total" % name)
              == getattr(rst, name), "router %s: page %s, status %s" % (
                  name, _mp_value(r_page, "edl_router_%s_total" % name),
                  getattr(rst, name)))
    errors = int(_mp_value(r_page, "edl_router_errors_total"))
    check(rst.routed == sent and rst.completed + errors + rst.shed == sent
          and rst.completed == codes.get("OK", 0),
          "router: routed %d completed %d errors %d shed %d of %d sent"
          % (rst.routed, rst.completed, errors, rst.shed, sent))
    slow = [0] * len(forensics.CAUSES)
    rep_rows, statuses = [], []
    for fams, s in zip(rep_pages, direct):
        st = s.server_status(wire_pb.ServerStatusRequest(), timeout=60)
        statuses.append(st)
        for name in ("admitted", "rejected", "expired", "completed",
                     "tokens_generated"):
            check(_mp_value(fams, "edl_serving_%s_total" % name)
                  == getattr(st, name), "replica %s: page %s, status %s"
                  % (name, _mp_value(fams, "edl_serving_%s_total" % name),
                     getattr(st, name)))
        page_slow = [int(_mp_value(fams, "edl_serving_slow_cause_total",
                                   {"cause": c})) for c in forensics.CAUSES]
        check(page_slow == list(st.slow_cause_counts), "slow causes: page "
              "%s, status %s" % (page_slow, list(st.slow_cause_counts)))
        slow = [a + b for a, b in zip(slow, page_slow)]
        rep_rows.append({"completed": st.completed, "expired": st.expired,
                         "slow_cause_counts": list(st.slow_cause_counts),
                         "ttft_exemplars": len(
                             fams["edl_serving_ttft_ms"]["exemplars"])})
    check(sum(slow) > 0, "no slow cause counted: %s" % slow)
    out["router"] = {"routed": rst.routed, "completed": rst.completed,
                     "errors": errors, "shed": rst.shed,
                     "e2e_p50_ms": rst.e2e_p50_ms,
                     "ttft_p50_ms": rst.ttft_p50_ms,
                     "ttft_p99_ms": rst.ttft_p99_ms}
    out["replicas"] = rep_rows
    out["slow_cause_counts"] = dict(zip(forensics.CAUSES, slow))
    # the collector CLI against the live router: no torch in its maps
    report_path = os.path.join(trace_dir, "cli_report.json")
    cli = _Child([sys.executable, "-m",
                  "elasticdl_tpu_torch.observability.collector",
                  "--endpoints", "127.0.0.1:%d" % r_mport, "--router",
                  "localhost:%d" % router.port, "--scrapes", "2",
                  "--interval", str(MP_COLLECTOR_INTERVAL_S), "--out",
                  report_path, "--trace_dir", trace_dir], "the collector")
    children.append(cli)
    time.sleep(MP_COLLECTOR_INTERVAL_S / 2)
    cli_torch_free = cli.proc.poll() is None and _torch_free(cli.proc.pid)
    rc = cli.proc.wait(timeout=120)
    check(rc == 0 and cli_torch_free, "the collector CLI: rc %s, torch free "
          "%s: %s" % (rc, cli_torch_free, cli.tail()))
    collector.validate_report(json.load(open(report_path)))
    out["collector_cli"] = {"rc": rc, "torch_free": cli_torch_free,
                            "s": time.perf_counter() - cli.t0}
    cli.close()
    # phase 35 (iii): SIGUSR2 to a live replica and the live router, each
    # still answering after its dump
    _sigusr2("replica", replicas[0].proc.pid, lambda: direct[0].server_status(
        wire_pb.ServerStatusRequest(), timeout=60))
    _sigusr2("router_main", router.proc.pid, lambda: stub.router_status(
        wire_pb.RouterStatusRequest(), timeout=60))
    # SIGTERM flushes each process's spans into the trace directory and
    # closes its event file
    for child in [router] + list(replicas):
        child.stop()
    out["tensorboard"] = _mp_event_files(trace_dir, statuses, rst, errors,
                                         sent)
    fleet_hist = LogLinearHistogram.from_counts(fleet)
    threshold = fleet_hist.percentile(0) / 2  # below the run's p50
    specs_slo = default_router_slos(threshold, 60000.0, 0.02,
                                    latency_goal=0.01)
    report = collector.validate_report(collector.build_report(
        bundle, specs_slo, trace_dir=trace_dir))
    resolved = [e for e in report["exemplars"] if e["resolved"]]
    causes = [report["traces"][e["trace_id"]]["attribution"][
        "dominant_cause"] for e in resolved]
    check("ttft_p99" in report["alerting"], "the report does not alert on "
          "ttft_p99 at %.3f ms: %s" % (threshold, report["slo"]))
    check(resolved and all(c in forensics.CAUSES for c in causes),
          "no exemplar resolved to an attributed trace: %s"
          % report["exemplars"])
    check(report["span_evidence"]["complete"], "span evidence incomplete: "
          "%s" % report["span_evidence"])
    out["report"] = {
        "ttft_threshold_ms": threshold,
        "fleet_ttft_p50_ms": fleet_hist.percentile(50),
        "alerting": report["alerting"],
        "slo": {r["name"]: {"fast_burn": r["fast_burn"],
                            "slow_burn": r["slow_burn"]}
                for r in report["slo"]},
        "exemplars": len(report["exemplars"]), "resolved": len(resolved),
        "dominant_causes": causes,
        "cause_histogram": report["cause_histogram"],
        "exports": report["span_evidence"]["exports"]}
    # the dump over the directory, and one router_generate -> dispatch ->
    # serve tree a routed request
    dump_out = os.path.join(trace_dir, "trace.json")
    d = subprocess.run([sys.executable, "-m",
                        "elasticdl_tpu_torch.observability.dump", "--dir",
                        trace_dir, "--out", dump_out], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    doc = json.load(open(dump_out))
    check(d.returncode == 0 and doc["otherData"]["evidence_complete"],
          "dump: rc %d %s" % (d.returncode, d.stdout + d.stderr))
    spans, _meta = dump.merge_dir(trace_dir)
    by_trace = group_by_trace(spans)
    for trace in results:
        tree = by_trace.get(trace, [])
        ids = {s["span_id"]: s for s in tree}

        def parent(span):
            return ids.get(span["parent_span_id"], {})

        roots = [s for s in tree if s["name"].startswith("router_generate")]
        chains = [s for s in tree if s["name"] == "serve"
                  and parent(s).get("name") == "dispatch"
                  and parent(parent(s)) in roots]
        check(len(roots) == 1 and len(chains) == 1, "trace %s is not one "
              "router_generate -> dispatch -> serve tree: %s" % (
                  trace, sorted((s["name"], s["status"]) for s in tree)))
    out["trees"] = len(results)
    out["dump"] = {"spans": len(spans), "traceEvents": len(
        doc["traceEvents"])}
    return out


MP_SERVING_TOTALS = ("admitted", "rejected", "expired", "completed",
                     "tokens_generated")
MP_ROUTER_TOTALS = ("routed", "completed", "shed", "redispatched", "hedges",
                    "breaker_trips", "affinity_hits", "affinity_misses")


def _mp_event_files(trace_dir, statuses, rst, errors, sent):
    """Each replica's `.serving` and the router's `.router` event file,
    read by read_event_file: the last counter totals equal the final
    status reads (the router's routed the `sent`)."""
    out = {"replicas": []}
    for i, st in enumerate(statuses):
        path = _event_file(_mp_tb_dir(trace_dir, "replica-%d" % i),
                           ".serving")
        got = _last_scalars(path, "serving/", MP_SERVING_TOTALS)
        want = {name: getattr(st, name) for name in MP_SERVING_TOTALS}
        check(got == want, "replica %d's event file ends with %s, its "
              "status %s" % (i, got, want))
        out["replicas"].append({"bytes": os.path.getsize(path),
                                "scalars": len(read_event_file(path)),
                                "totals": got})
    path = _event_file(_mp_tb_dir(trace_dir, "router"), ".router")
    got = _last_scalars(path, "router/", MP_ROUTER_TOTALS + ("errors",))
    want = dict({name: getattr(rst, name) for name in MP_ROUTER_TOTALS},
                errors=errors)
    check(got == want and got["routed"] == sent, "the router's event file "
          "ends with %s, its status %s, %d sent" % (got, want, sent))
    out["router"] = {"bytes": os.path.getsize(path),
                     "scalars": len(read_event_file(path)), "totals": got}
    log("metrics_plane event files: %s" % json.dumps(out))
    return out


def start_metrics_replicas(device="cuda", trace_dir=None):
    """Phase 34 (b)'s two replica processes (the script starts them
    early, beside the kernel checks: untimed work); they warm up and wait
    idle. Returns (the children, their trace directory)."""
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="metrics_plane_")
    return [_Child([
        sys.executable, "-m", "elasticdl_tpu_torch.serving.main",
        "--device", device, "--kv_paged", "1", "--metrics_port", "0",
        "--port", "0", "--model_params", _params_str(FLAGSHIP),
        "--num_slots", str(MP_SLOTS), "--kv_block_size", "16",
        "--warmup_tokens", "2", "--tensorboard_log_dir",
        _mp_tb_dir(trace_dir, "replica-%d" % i)], "metrics replica %d" % i,
        extra_env={"EDL_TRACE_DIR": trace_dir}) for i in range(2)], trace_dir


def _mp_tb_dir(trace_dir, process):
    """Each process of phase 34's fleet writes its event file in a
    directory of its own (two started in one second would share a file
    name)."""
    return os.path.join(trace_dir, "tb", process)


def metrics_plane_phase(specs, device="cuda", model=None, early=None):
    """Phase 34: the metrics plane and tail forensics on the serving
    fleet. (a) the specs twice through an in-process replica over `model`
    (the flagship's, seeded; made here when None), plane off then on
    (scraped throughout): streams and A / B launches equal, tokens/s and
    the scrape's and render's ms a record. (b) the fleet (_mp_fleet),
    its replica processes `early` = start_metrics_replicas()'s, started
    beside the kernel checks, else here after (a), so that their start-up
    does not share the host with (a)'s passes. Returns the line and (a)'s
    launches by pass."""
    on_card = device == "cuda"
    children, trace_dir = early if early is not None else ([], None)
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="metrics_plane_")
    out, launches = {}, {}
    try:
        if model is None:
            model = TransformerLM(device=device, seed=0, **FLAGSHIP)
        streams = {}
        for name, plane_on in (("plane_off", False), ("plane_on", True)):
            streams[name], launches[name], out[name] = _mp_pass(
                model, specs, plane_on, device)
        check(streams["plane_on"] == streams["plane_off"], "the plane "
              "changed the streams from position %s" % (_first_divergence(
                  sum(streams["plane_on"], []),
                  sum(streams["plane_off"], [])),))
        check(launches["plane_on"] == launches["plane_off"], "the plane "
              "changed the launches: %s" % launches)
        if on_card:
            for name in ("flash_fwd", "paged_decode"):
                check(launches["plane_on"][name] > 0, "kernel %s was not "
                      "launched on the metrics plane's path" % name)
        out["streams_equal"] = len(streams["plane_on"])
        out["launches"] = launches
        out["on_over_off_tokens_per_s"] = (
            out["plane_on"]["decode_tokens_per_s"]
            / out["plane_off"]["decode_tokens_per_s"])
        if not children:
            children += start_metrics_replicas(device, trace_dir)[0]
        out["fleet"] = _mp_fleet(specs, trace_dir, children)
        out["tensorboard"] = out["fleet"].pop("tensorboard")
    finally:
        for child in children:
            child.close()
        shutil.rmtree(trace_dir, ignore_errors=True)
    log("metrics_plane: %s" % json.dumps(out))
    return out, launches


RH_SEED = 35
RH_LONG, RH_LONG_NEW, RH_LONG_PROMPT = 6, 96, 64  # the drill's burst
RH_POST, RH_POST_NEW = 3, 16  # after the replacement
RH_STALL_AFTER_S = 2.0  # the drill replicas' watchdog budget
RH_STALLED_KILL_AFTER_S = 1.5  # the supervisor's self-report budget
RH_WEDGED_AFTER_S = 30.0  # the lease heuristic, kept
#: the first seat wedges on its 6th decode tick (its warmup of 4 tokens
#: takes 3: the burst's third tick), with requests seated
RH_STALL_SPEC = "engine_step:delay:1:secs=600,skip=5"
#: the sibling leaks 8 MiB at its 2nd reconcile after the steady mark
#: (reconciles 2 s apart), 2-4 s after it is ready: its idle drift is
#: read first, as soon as it is ready
RH_LEAK_SKIP = 1
RH_LEAK_SPEC = "health_leak:drop:1:skip=%d" % RH_LEAK_SKIP
RH_LEAK_BYTES = 8 << 20
RH_WAIT_S = 300
#: phase 34's pass of the 16 requests: A's prefills, B's split kernel
#: (8 layers a decode step) and its tile kernel (the prefix hits' suffix
#: tiles)
RH_LAUNCHES = {"flash_fwd": 72, "paged_decode": 1872,
               "paged_decode_tile": 32}
#: what each process of the script saw: SIGUSR2 dumps by process kind
#: (phases 24 and 34 send them; this phase's line reports them)
SIGUSR2_DUMPS = {}


def _health_dir():
    """The script's EDL_HEALTH_DIR (main sets it): every replica, router
    and job process started by a phase writes its stall bundles and
    SIGUSR2 dumps there."""
    return os.environ.get("EDL_HEALTH_DIR", "")


def _stall_bundles(health_dir=None):
    health_dir = health_dir if health_dir is not None else _health_dir()
    if not health_dir or not os.path.isdir(health_dir):
        return []
    return sorted(f for f in os.listdir(health_dir)
                  if f.startswith("health-bundle-") and f.endswith(".json"))


def _no_stalls(where):
    """No process of the script so far read as stalled: no stall bundle
    in the script's health directory."""
    bundles = _stall_bundles()
    check(not bundles, "%s: a healthy process read as stalled: %s"
          % (where, bundles))
    return 0


def _sigusr2(kind, pid, alive_check):
    """SIGUSR2 to live process `pid`: its all-thread stacks (a block for
    each Python thread) must land in sigusr2-<pid>.txt in the script's
    health directory, and `alive_check()` (a call it serves) must pass
    after. Records the result under `kind`."""
    path = os.path.join(_health_dir(), "sigusr2-%d.txt" % pid)
    t0 = time.perf_counter()
    os.kill(pid, signal.SIGUSR2)
    deadline = time.monotonic() + 30
    text, threads = "", 0
    while time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path, errors="replace") as f:
                got = f.read()
            # the dump is written thread by thread: done once the file
            # stops growing (the signal may land on a thread Python does
            # not run, so no block need say "Current thread")
            if "most recent call first" in got and got == text:
                threads = len(re.findall(r"^(?:Current thread|Thread) 0x",
                                         text, re.M))
                break
            text = got
        time.sleep(0.2)
    check(threads >= 1, "%s (pid %d): no all-thread dump in %s after "
          "SIGUSR2: %r" % (kind, pid, path, text[-500:]))
    alive_check()
    SIGUSR2_DUMPS[kind] = {"pid": pid, "threads": threads,
                           "bytes": len(text),
                           "dump_s": time.perf_counter() - t0}


def _rh_warm(server, vocab):
    """The shapes of the serving path at this configuration, before the
    steady mark: one request a prefill bucket (its prompt 2 tokens short
    of the bucket), then MP_SLOTS requests of 2..MP_SLOTS + 1 tokens
    seated together, so the decode step runs every active-slot count
    (the port's step runs the active slots only: one signature a count);
    the prefix index flushed after, so the pass seats as phase 34's
    did."""
    seq = server.engine.seq_len
    for i, bucket in enumerate(range(64, seq + 1, 64)):
        server.generate([(7 + i) % vocab] * (bucket - 2), 2)
    _tiers_pass(server, [([3, 4 + i], 2 + i) for i in range(MP_SLOTS)])
    server.scheduler.submit_job(server.engine.kv.flush_prefix_cache)


def _rh_pass(model, specs, health_on, device):
    """Phase 35 (i): phase 34's requests through an in-process replica
    at the flagship's serving configuration, the runtime-health plane off
    or on, after the shape warmup and the steady mark."""
    server = GenerationServer(model, ServingConfig(
        num_slots=MP_SLOTS, queue_capacity=64, kv_paged=True,
        kv_block_size=16, kv_shared=True,
        runtime_health=health_on)).start()
    try:
        _rh_warm(server, model.vocab_size)
        server.telemetry.reset_latency()
        server.mark_steady()
        _sync(device)
        att.reset_launch_counts()
        reqs, times = _tiers_pass(server, specs)
        _sync(device)
        launches = {n: att.KERNEL_LAUNCHES[n] for n in SERVING_KERNELS}
        tokens = sum(len(r.generated) for r in reqs)
        out = dict(times, tokens=tokens,
                   decode_tokens_per_s=tokens / times["wall_s"])
        if health_on:
            health = server.health
            out["health"] = health.snapshot()
            snap = health.sentry.snapshot()
            out["compiles"] = snap["compiles"]
            out["builds"] = snap["builds"]
            # an idle reconcile after the pass (the scheduler is idle)
            view = health.accountant.reconcile()
            out["idle_unaccounted_bytes"] = view["unaccounted_bytes"]
            out["unaccounted_peak_bytes"] = view["unaccounted_peak_bytes"]
            out["ledger"] = view["ledger"]
            out["live_bytes"] = view["live_bytes"]
            out["ring_recorded"] = health.recorder.recorded
        else:
            check(server.health is None, "the plane is on in the off pass")
    finally:
        server.stop(timeout=120)
    check(server.scheduler.crashed is None,
          "scheduler crashed: %r" % (server.scheduler.crashed,))
    return [list(r.generated) for r in reqs], launches, out


def _rh_in_process(model, specs, device):
    out, streams, launches = {}, {}, {}
    for name, on in (("plane_off", False), ("plane_on", True)):
        streams[name], launches[name], out[name] = _rh_pass(
            model, specs, on, device)
    check(streams["plane_on"] == streams["plane_off"], "the health plane "
          "changed the streams from position %s" % (_first_divergence(
              sum(streams["plane_on"], []), sum(streams["plane_off"], [])),))
    check(launches["plane_on"] == launches["plane_off"], "the health plane "
          "changed the launches: %s" % launches)
    if device == "cuda":
        check(launches["plane_on"] == RH_LAUNCHES, "the pass launched %s, "
              "not %s" % (launches["plane_on"], RH_LAUNCHES))
    h = out["plane_on"]["health"]
    check(h["jit_compiles"] > 0 and h["steady_marked"]
          and h["steady_recompiles"] == 0 and h["stalls"] == 0
          and h["health_state"] == "ok", "the plane's self-report after "
          "the pass: %s" % h)
    out["launches"] = launches
    out["streams_equal"] = len(streams["plane_on"])
    out["on_over_off_tokens_per_s"] = (
        out["plane_on"]["decode_tokens_per_s"]
        / out["plane_off"]["decode_tokens_per_s"])
    return out


class _SeatLauncher(object):
    """The drill's replica launcher: seat 0 is born with the stall
    armed, seat 1 with the leak; later seats (the replacement) come up
    clean, so the fleet converges. `prespawn(seat)` starts a seat ahead
    of the supervisor, whose spawn of that seat then takes it."""

    def __init__(self, base, env, seat_specs):
        self._base, self._env, self._specs = base, env, seat_specs
        self.spawned = {}
        self._held = {}

    def _start(self, seat_id):
        env = dict(self._env)
        spec = self._specs.get(seat_id)
        if spec:
            env["EDL_FAULT_SPEC"] = spec
        self._base.env = env
        handle = self._base.spawn(seat_id)
        self.spawned[seat_id] = handle
        return handle

    def prespawn(self, seat_id):
        self._held[seat_id] = self._start(seat_id)

    def spawn(self, seat_id):
        held = self._held.pop(seat_id, None)
        return held if held is not None else self._start(seat_id)

    def attach(self, seat_id, pid, log_path):
        return self._base.attach(seat_id, pid, log_path)


def _rh_status(stub):
    try:
        return stub.router_status(wire_pb.RouterStatusRequest(), timeout=20)
    except wire_service.RpcError:
        return None


def _rh_wait(pred, what, timeout=RH_WAIT_S, poll=0.05):
    deadline = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        check(time.monotonic() < deadline, "the stall drill timed out "
              "waiting for %s" % what)
        time.sleep(poll)


def _seat_log(launcher, seat):
    handle = launcher.spawned.get(seat)
    if handle is None or not os.path.exists(handle.log_path):
        return ""
    with open(handle.log_path, errors="replace") as f:
        return f.read()


def _rh_read_before(launcher, out):
    """The sibling's (seat 1's) idle drift, read as soon as it is ready,
    before its leak fires (2-4 s after its steady mark): into `out`."""
    try:
        addr = _rh_wait(lambda: launcher.spawned[1].ready(),
                        "the sibling to be ready", poll=0.02)
        out["ready_at"] = time.monotonic()
        stub = wire_service.ServingStub(wire_service.build_channel(addr))
        out["status"] = stub.server_status(wire_pb.ServerStatusRequest(),
                                           timeout=20)
        out["leak_logged"] = "leaked" in _seat_log(launcher, 1)
        out["address"] = addr
    except Exception as e:  # noqa: BLE001 - the drill reports it
        out["error"] = repr(e)


def start_drill_seats(device="cuda"):
    """Phase 35 (ii)'s first two replicas (the script starts them early,
    beside the kernel checks; they warm up and wait idle): seat 0 born
    with RH_STALL_SPEC, seat 1 with RH_LEAK_SPEC, both with
    --stall_after_secs RH_STALL_AFTER_S and the drill's EDL_HEALTH_DIR;
    a thread reads the sibling's idle drift as soon as it is ready.
    Returns the handle _rh_drill takes."""
    from elasticdl_tpu_torch.serving.autoscaler import (
        SubprocessReplicaLauncher,
    )

    root = tempfile.mkdtemp(prefix="stall_drill_")
    health_dir = os.path.join(root, "health")
    os.makedirs(health_dir)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, EDL_HEALTH_DIR=health_dir)
    env.pop("EDL_FAULT_SPEC", None)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    args = ["--device", device, "--kv_paged", "1", "--kv_block_size", "16",
            "--num_slots", str(MP_SLOTS), "--port", "0",
            "--model_params", _params_str(FLAGSHIP), "--warmup_tokens", "4",
            "--runtime_health", "1",
            "--stall_after_secs", str(RH_STALL_AFTER_S)]
    launcher = _SeatLauncher(
        SubprocessReplicaLauncher(args, os.path.join(root, "logs"), env=env,
                                  cwd=repo),
        env, {0: RH_STALL_SPEC, 1: RH_LEAK_SPEC})
    t_spawn = time.monotonic()
    for seat in (0, 1):
        launcher.prespawn(seat)
    before = {}
    reader = threading.Thread(target=_rh_read_before,
                              args=(launcher, before), daemon=True)
    reader.start()
    return {"root": root, "health_dir": health_dir, "launcher": launcher,
            "before": before, "reader": reader, "t_spawn": t_spawn}


def close_drill_seats(seats):
    for handle in seats["launcher"].spawned.values():
        if handle.poll() is None:
            handle.kill()
            _rh_wait(lambda h=handle: h.poll() is not None,
                     "a drill replica to die", timeout=30)
    shutil.rmtree(seats["root"], ignore_errors=True)


def _rh_drill(device, rs, seats=None):
    """Phase 35 (ii): the stall drill (see the module docstring) over
    `seats` (start_drill_seats'; started here when None)."""
    from elasticdl_tpu_torch.observability.runtime_health import (
        validate_bundle,
    )
    from elasticdl_tpu_torch.serving.autoscaler import (
        AutoscalerConfig,
        ReplicaSupervisor,
    )
    from elasticdl_tpu_torch.serving.router import Router, RouterConfig

    seats = seats or start_drill_seats(device)
    root, health_dir = seats["root"], seats["health_dir"]
    launcher = seats["launcher"]
    router = Router([], RouterConfig(
        poll_secs=0.25, poll_timeout_secs=2.0, lease_secs=2.0,
        breaker_cooldown_secs=1.0, redispatch_window_secs=120.0,
        dispatch_timeout_secs=150.0, max_workers=96)).start()
    sup = ReplicaSupervisor(router, launcher, AutoscalerConfig(
        min_replicas=2, max_replicas=2, decide_secs=0.25,
        ready_timeout_secs=RH_WAIT_S, drain_timeout_secs=60.0,
        wedged_after_secs=RH_WEDGED_AFTER_S,
        stalled_kill_after_secs=RH_STALLED_KILL_AFTER_S, max_restarts=3,
        journal_dir=os.path.join(root, "journal")))
    router.set_autoscaler(sup)
    out, timeline, outcomes = {}, {}, {}
    t_start = time.monotonic()

    def stamp(name):
        timeline[name] = time.monotonic() - t_start

    stub = wire_service.RouterStub(wire_service.build_channel(
        "localhost:%d" % router.port))
    vocab = FLAGSHIP["vocab_size"]

    def call(tag, prompt, new):
        r = _routed(stub, "router_generate", tag, prompt, new)
        outcomes[tag] = r["code"] or ("OK" if r["done"] and len(
            r["tokens"]) == new else "INCOMPLETE")

    def seat_log(seat):
        return _seat_log(launcher, seat)

    try:
        sup.start()
        # the leak from the sibling's idle reconciles: before (read as
        # soon as it was ready, no leak logged yet) ...
        seats["reader"].join(timeout=RH_WAIT_S)
        got = seats["before"]
        check("status" in got and not got["leak_logged"], "the sibling's "
              "idle drift before its leak was not read: %s" % got)
        stamp("sibling_ready")
        out["seats_ready_s"] = got["ready_at"] - seats["t_spawn"]
        before = got["status"]
        leak_stub = wire_service.ServingStub(wire_service.build_channel(
            got["address"]))

        def leak_status():
            return leak_stub.server_status(wire_pb.ServerStatusRequest(),
                                           timeout=20)

        check(before.memory_unaccounted_bytes < RH_LEAK_BYTES
              and before.health_state == "ok", "the sibling's idle drift "
              "before the leak: %d bytes, %r"
              % (before.memory_unaccounted_bytes, before.health_state))
        # ... and after
        after = _rh_wait(lambda: (lambda s: s if s.memory_unaccounted_bytes
                                  >= RH_LEAK_BYTES else None)(leak_status()),
                         "the accountant to convict the leak", timeout=60,
                         poll=0.25)
        check("leaked %d device bytes" % RH_LEAK_BYTES in seat_log(1),
              "the sibling logged no leak")
        stamp("leak_convicted")
        _rh_wait(lambda: (lambda st: st is not None
                          and st.autoscaler.live >= 2
                          and st.healthy >= 2)(_rh_status(stub)),
                 "both replicas live")
        stamp("fleet_live")
        st = _rh_status(stub)
        addr = {launcher.spawned[s].ready(): s for s in (0, 1)}
        check(set(addr) == {r.address for r in st.replica},
              "the fleet %s is not the two seats %s"
              % ([r.address for r in st.replica], addr))
        out["leak"] = {"spec": RH_LEAK_SPEC, "leaked_bytes": RH_LEAK_BYTES,
                       "idle_before_bytes": before.memory_unaccounted_bytes,
                       "idle_after_bytes": after.memory_unaccounted_bytes,
                       "convicted": after.memory_unaccounted_bytes
                       >= RH_LEAK_BYTES}
        # the stall: a burst of long requests over both seats
        threads = []
        for i in range(RH_LONG):
            prompt = rs.randint(0, vocab, size=RH_LONG_PROMPT).tolist()
            threads.append(threading.Thread(target=call, args=(
                "rh-long-%d" % i, prompt, RH_LONG_NEW), daemon=True))
        t_dispatch = time.monotonic()
        for t in threads:
            t.start()
        stamp("burst_dispatched")

        def stalled():
            st = _rh_status(stub)
            for r in (st.replica if st is not None else ()):
                if r.health_state == "stalled":
                    return r
            return None

        rep = _rh_wait(stalled, "a replica to self-report stalled",
                       timeout=RH_WEDGED_AFTER_S, poll=0.02)
        t_detect = time.monotonic()
        stamp("stall_detected")
        check(addr.get(rep.address) == 0, "seat %s reads stalled, not the "
              "armed seat 0" % addr.get(rep.address))
        detect_s = t_detect - t_dispatch
        out["detect"] = {"s": detect_s, "age_ms": rep.last_progress_age_ms,
                         "lease_remaining_secs": rep.lease_remaining_secs,
                         "router_healthy": rep.healthy}
        check(detect_s <= RH_STALL_AFTER_S + 2.0, "detection took %.2f s "
              "from the dispatch (bound %.1f)" % (detect_s,
                                                  RH_STALL_AFTER_S + 2.0))
        dropped = _rh_wait(lambda: (lambda st: st is not None and any(
            r.address == rep.address and not r.healthy
            for r in st.replica))(_rh_status(stub)),
            "the router to drop the stalled replica", timeout=10, poll=0.02)
        out["router_dropped"] = bool(dropped)
        _rh_wait(lambda: (lambda st: st is not None
                          and st.autoscaler.replacements >= 1)(
            _rh_status(stub)), "the stalled replica to be killed",
            timeout=RH_WEDGED_AFTER_S, poll=0.02)
        t_kill = time.monotonic()
        stamp("replica_killed")
        kill_s = t_kill - t_dispatch
        check(kill_s < RH_WEDGED_AFTER_S, "dispatch to kill took %.1f s, no "
              "faster than the %.0f s lease heuristic"
              % (kill_s, RH_WEDGED_AFTER_S))
        rc = _rh_wait(lambda: (lambda rc: None if rc is None else [rc])(
            launcher.spawned[0].poll()), "seat 0 to exit", timeout=30)[0]
        out["kill"] = {"s": kill_s, "rc": rc}
        check(rc == -signal.SIGKILL, "seat 0 exited %s, not by SIGKILL" % rc)
        _rh_wait(lambda: (lambda st: st is not None
                          and st.autoscaler.live >= 2
                          and st.healthy >= 2)(_rh_status(stub)),
                 "the replacement to go live")
        t_live = time.monotonic()
        stamp("replacement_live")
        out["replacement_live_s"] = t_live - t_kill
        check(2 in launcher.spawned, "no replacement seat was spawned")
        for t in threads:
            t.join(timeout=RH_WAIT_S)
            check(not t.is_alive(), "a wedged request hung: %s" % outcomes)
        stamp("burst_done")
        for i in range(RH_POST):
            prompt = rs.randint(0, vocab, size=RH_LONG_PROMPT).tolist()
            call("rh-post-%d" % i, prompt, RH_POST_NEW)
        stamp("post_done")
        out["outcomes"] = dict(outcomes)
        check(len(outcomes) == RH_LONG + RH_POST and set(
            outcomes.values()) == {"OK"}, "outcomes: %s" % outcomes)
        # the bundle the stalled replica left
        bundles = _stall_bundles(health_dir)
        check(len(bundles) == 1, "stall bundles: %s" % bundles)
        with open(os.path.join(health_dir, bundles[0])) as f:
            bundle = json.load(f)
        problems = validate_bundle(bundle)
        sched = [t for t in bundle["stacks"]["threads"]
                 if t["thread"] == "serving-scheduler"]
        asleep = bool(sched) and "fault_injection" in "".join(
            sched[0]["stack"])
        check(not problems and bundle["reason"] == "progress_stall"
              and bundle["ring"] and asleep and bundle["pid"]
              == launcher.spawned[0].pid, "the bundle: problems %s, "
              "reason %s, %d ring ticks, scheduler asleep %s"
              % (problems, bundle["reason"], len(bundle["ring"]), asleep))
        out["bundle"] = {"valid": True, "ring_ticks": len(bundle["ring"]),
                         "scheduler_asleep": asleep,
                         "compiles": bundle["recompiles"]["total_compiles"],
                         "stalls": bundle["health"]["stalls"],
                         "age_ms": bundle["health"]["last_progress_age_ms"]}
        stamp("bundle_validated")
        st = _rh_status(stub)
        out["autoscaler"] = {"live": st.autoscaler.live,
                             "replacements": st.autoscaler.replacements}
    finally:
        sup.stop(grace=20.0)
        router.stop()
        close_drill_seats(seats)
    out["timeline_s"] = timeline
    out["bounds"] = {"stall_after_secs": RH_STALL_AFTER_S,
                     "stalled_kill_after_secs": RH_STALLED_KILL_AFTER_S,
                     "wedged_after_secs": RH_WEDGED_AFTER_S,
                     "detect_bound_s": RH_STALL_AFTER_S + 2.0}
    return out


def runtime_health_phase(model, specs, device="cuda", seats=None):
    """Phase 35: the runtime-health plane (see the module docstring),
    the drill over `seats` (start_drill_seats', when the script started
    them early). Returns the line."""
    out = {"in_process": _rh_in_process(model, specs, device)}
    out["drill"] = _rh_drill(device, np.random.RandomState(RH_SEED), seats)
    out["sigusr2"] = dict(SIGUSR2_DUMPS)
    check(set(SIGUSR2_DUMPS) == {"replica", "router_main", "master",
                                 "worker"},
          "SIGUSR2 dumps of %s, not of a replica, router_main, the master "
          "and a worker" % sorted(SIGUSR2_DUMPS))
    out["stall_bundles_elsewhere"] = len(_stall_bundles())
    _no_stalls("runtime_health")
    log("runtime_health: %s" % json.dumps(out))
    return out


class _Early(object):
    """The children the script starts early, each for a later phase: the
    README quickstart and phase 33's iris job (whole jobs with no timed
    section and no kernel of the port) beside the build's tail; after
    the build, beside the kernel checks (untimed work), the sp ranks and
    checkpoint run 1 (at their gates, their timed work after the go),
    phase 34's two replicas and phase 35's two drill seats (ready, then
    idle). `settle()`, before the first timed section, waits until each
    is at its gate, ready or done, so none starts up beside timed
    work."""

    def __init__(self, device):
        self.quickstart = start_quickstart(device)
        self.iris = start_iris_job(device)
        self.sp = self.ckpt = self.metrics = self.seats = None
        self.settle_s = self.ready_s = None
        atexit.register(self.close)

    def after_build(self, device):
        self.sp = start_sp_ranks()
        self.ckpt = start_ckpt_run1()
        self.metrics = start_metrics_replicas(device)
        self.seats = start_drill_seats(device)

    def settle(self):
        t0 = time.perf_counter()
        ready = {
            "sp_ranks": _gated_ready(
                self.sp["go"], ["rank%d" % r for r in range(SP)],
                self.sp["procs"], "the sp ranks") - self.sp["t_spawn"],
            "ckpt_run1": _gated_ready(
                self.ckpt["go"], ["ckpt"], [self.ckpt["proc"]],
                "checkpoint run 1") - self.ckpt["t_spawn"]}
        for i, child in enumerate(self.metrics[0]):
            child.line("SERVING_READY")
            ready["replica%d" % i] = child.ready_s
        launcher = self.seats["launcher"]
        _rh_wait(lambda: launcher.spawned[0].ready(), "drill seat 0")
        ready["drill_seat0"] = time.monotonic() - self.seats["t_spawn"]
        self.seats["reader"].join(timeout=RH_WAIT_S)
        ready["drill_seat1"] = self.seats["before"].get(
            "ready_at", time.monotonic()) - self.seats["t_spawn"]
        for name, job, wait_s in (
                ("quickstart", self.quickstart, VIS_QUICKSTART_WAIT_S),
                ("iris_job", self.iris, ENC_IRIS_WAIT_S)):
            try:
                job["proc"].wait(timeout=wait_s)
            except subprocess.TimeoutExpired:
                pass  # its phase fails it
            ready[name] = job.get("t_end", time.perf_counter()) - job["t0"]
        self.settle_s = time.perf_counter() - t0
        self.ready_s = ready
        log("early children settled after %.1f s more: seconds from each "
            "one's start to its gate, its ready line or its end: %s"
            % (self.settle_s, json.dumps(ready)))

    def close(self):
        close_job(self.quickstart)
        close_job(self.iris)
        if self.sp is None:
            return
        close_sp_ranks(self.sp)
        close_ckpt_run1(self.ckpt)
        for child in self.metrics[0]:
            child.close()
        shutil.rmtree(self.metrics[1], ignore_errors=True)
        close_drill_seats(self.seats)


class _Laps(object):
    """Seconds of the script's run by JSON line: `to(name)` charges the
    time since the last call to the line it was charging and starts
    charging `name` (None: stop), and logs the lap it closed."""

    def __init__(self, first):
        self.secs = {}
        self._name, self._t0 = first, time.perf_counter()

    def to(self, name):
        now = time.perf_counter()
        self.secs[self._name] = self.secs.get(self._name, 0.0) + (
            now - self._t0)
        log("lap %s: %.1f s (%.1f s in all)" % (
            self._name, now - self._t0, self.secs[self._name]))
        self._name, self._t0 = name, now


def main():
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("card: %s | torch %s cuda %s | %s"
        % (smi, torch.__version__, torch.version.cuda, kind))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN (fp32 comparisons in full fp32)")
    # every process the phases start writes its stall bundles and SIGUSR2
    # dumps here (runtime health); a bundle is a process that read as
    # stalled
    health_dir = tempfile.mkdtemp(prefix="edl_health_")
    os.environ["EDL_HEALTH_DIR"] = health_dir
    atexit.register(shutil.rmtree, health_dir, True)

    laps = _Laps("kernels")
    early = _Early("cuda")
    t0 = time.perf_counter()
    if _EARLY_BUILD is not None:
        # started before the imports: its seconds run from its own start
        _EARLY_BUILD["thread"].join()
        if "error" in _EARLY_BUILD:
            raise _EARLY_BUILD["error"]
        report = _EARLY_BUILD["report"]
        t0 = _EARLY_BUILD["t0"]
        log("the build ran beside the script's imports; %.1f s of it was "
            "left after them" % (_EARLY_BUILD["t_end"] - t_script))
    else:
        report = _build.build()
    log("kernels built in %.1f s: %s" % (
        time.perf_counter() - t0,
        ", ".join("%s %.1f s" % (n, r["seconds"]) for n, r in
                  report.items())))

    early.after_build("cuda")
    builds = flash_builds(report)
    # the fp32 instances' SASS, read after the kernel checks
    f32_sass = {name: start_sass(_build.library_path(name))
                for name in ("flash_fwd", "flash_bwd")}
    gen = torch.Generator().manual_seed(0)
    rng = np.random.RandomState(0)
    # the packed and windowed phases draw from their own generators, so
    # every earlier phase sees the data it saw before they were added
    gen_masked = torch.Generator().manual_seed(5)
    rng_masked = np.random.RandomState(5)
    flash_err = check_flash(gen)
    # the instance checks draw from their own generator, so every later
    # phase sees the data it saw before they were added
    fwd_instances = check_flash_instances(torch.Generator().manual_seed(8))
    # so does the forward's rounding probe
    fwd_rounding = check_fwd_rounding(torch.Generator().manual_seed(9))
    paged_err = check_paged(gen)
    int8_err = check_paged_int8(gen)
    # the sweeps draw from their own generators, so every later phase
    # sees the data it saw before they were added
    paged_sweep = check_paged_sweep(torch.Generator().manual_seed(10))
    bwd_err = check_flash_bwd(gen)
    autograd_err = check_autograd(gen)
    # the rounding probe draws from its own generator, so every later
    # phase sees the data it saw before it was added
    bwd_rounding = check_bwd_rounding(torch.Generator().manual_seed(7))
    # and so do the fp32 checks at vit's width
    vit_bwd = check_vit_bwd(torch.Generator().manual_seed(VIT_BWD_SEED))
    vit_fwd = check_vit_fwd(torch.Generator().manual_seed(VIT_FWD_SEED))
    gather_err = check_gather(gen)
    row_err = check_row_update(gen)
    # the grouped sweep draws from its own generator, so every later
    # phase sees the data it saw before it was added
    grouped_sweep = check_grouped_sweep(torch.Generator().manual_seed(13))
    dense_err = check_dense_update(gen)
    dense_edges = check_dense_edges(torch.Generator().manual_seed(12))
    masked_err, masked_path_err, masked_inputs = check_masked_flash(
        gen_masked, rng_masked)
    masked_paged_err, masked_paged_cases = check_masked_paged(gen_masked)
    # the sp phases draw from their own generator too
    gen_sp = torch.Generator().manual_seed(6)
    offset_err, offset_path_err, offset_inputs = check_offset_flash(gen_sp)
    ring_rotations = check_ring_rotations(gen_sp)
    builds["flash_f32_sass"] = {}
    for name, expected in (("flash_fwd", 6), ("flash_bwd", 8)):
        builds["flash_f32_sass"].update(flash_f32_sass(f32_sass[name],
                                                       expected))
    log("fp32 forward and backward instances' SASS (no tensor-core product, "
        "no 16-bit or TF32 conversion): %s"
        % json.dumps(builds["flash_f32_sass"]))
    early.settle()
    laps.to("serving")
    specs = serving_specs(rng)
    bf16_streams = []
    serving, launches = serve_flagship(specs, streams_out=bf16_streams)
    log("serving run launches: %s" % launches)
    int8_streams = []
    serving["int8"], int8_launches = serve_flagship(
        specs, "int8", streams_out=int8_streams)
    log("int8 serving run launches: %s; %s" % (
        int8_launches, json.dumps(serving["int8"])))
    # the same blocks, each row and kv head d int8 values and a 4-byte
    # scale in place of d bf16 values: (128 + 4) / 256 of the bytes
    check(serving["int8"]["kv_blocks_total"] == serving["kv_blocks_total"]
          and serving["int8"]["kv_bytes_total"] * 256
          == serving["kv_bytes_total"] * (128 + 4),
          "int8 pool holds %d bytes, bf16 pool %d"
          % (serving["int8"]["kv_bytes_total"], serving["kv_bytes_total"]))
    laps.to("windowed")
    windowed = {"attn_window": WINDOW}
    windowed["serving"], win_launches = serve_flagship(specs,
                                                       attn_window=WINDOW)
    log("windowed serving run launches: %s; %s" % (
        win_launches, json.dumps(windowed["serving"])))
    windowed["serving"]["int8"], win_int8_launches = serve_flagship(
        specs, "int8", attn_window=WINDOW)
    log("windowed int8 serving run launches: %s; %s" % (
        win_int8_launches, json.dumps(windowed["serving"]["int8"])))
    windowed["streams_cuda_vs_cpu"] = compare_windowed_streams(rng_masked)
    laps.to("serving")
    serving["cuda_vs_cpu"] = compare_cuda_cpu(rng)
    serving["int8"]["cuda_vs_cpu_fp32"] = compare_cuda_cpu_int8(rng)
    serving["decode_profile"] = profile_decode(rng)
    log("decode profile: %s" % json.dumps(serving["decode_profile"]))
    serving["int8"]["decode_profile"] = profile_decode(rng,
                                                       kv_cache_dtype="int8")
    log("int8 decode profile: %s"
        % json.dumps(serving["int8"]["decode_profile"]))
    laps.to("training")
    with tempfile.TemporaryDirectory() as workdir:
        training, executor, train_launches = train_flagship(rng, workdir)
    log("training run launches: %s" % train_launches)
    training["step_profile"] = profile_train_step(executor, rng)
    log("training step profile: %s" % json.dumps(training["step_profile"]))
    del executor
    laps.to("windowed")
    with tempfile.TemporaryDirectory() as workdir:
        windowed["training"], executor, win_train_launches = train_flagship(
            rng_masked, workdir, attn_window=WINDOW)
    log("windowed training run launches: %s" % win_train_launches)
    windowed["training"]["step_profile"] = profile_train_step(executor,
                                                              rng_masked)
    log("windowed training step profile: %s"
        % json.dumps(windowed["training"]["step_profile"]))
    del executor
    laps.to("packed")
    packed = {}
    with tempfile.TemporaryDirectory() as workdir:
        packed["family"], family_launches = train_packed_family(rng_masked,
                                                                workdir)
    log("packed family launches: %s; %s" % (family_launches,
                                            json.dumps(packed["family"])))
    packed["flagship"], packed_flagship_launches = train_packed_flagship(
        rng_masked)
    packed["logits_vs_documents"] = compare_packed_rows(rng_masked)
    torch.cuda.empty_cache()
    laps.to("sp")
    sp, sp_launches = train_sp(early.sp)
    sp["ring_rotations_vs_unsharded"] = ring_rotations
    laps.to("training")
    training["cuda_vs_cpu_step"] = compare_train_step(rng)
    training["autograd_cuda_vs_cpu_rel_err"] = autograd_err
    training["flash_fwd_build"] = builds.get("flash_fwd", {})
    training["flash_bwd_build"] = builds.get("flash_bwd", {})
    training["flash_f32_sass"] = builds["flash_f32_sass"]
    training["flash_fwd_instances"] = fwd_instances
    training["flash_fwd_rounding"] = fwd_rounding
    training["flash_bwd_rounding"] = bwd_rounding
    laps.to("dlrm")
    with tempfile.TemporaryDirectory() as workdir:
        dlrm, executor, dlrm_launches = train_dlrm(rng, workdir)
    log("dlrm run launches: %s" % dlrm_launches)
    for name in DLRM_KERNELS:
        check(dlrm_launches[name] > 0,
              "kernel %s was not launched on the DLRM path" % name)
    dlrm["step_profile"], uniform_batch = time_dlrm_steps(executor, rng)
    log("dlrm step profile: %s" % json.dumps(dlrm["step_profile"]))
    del executor
    torch.cuda.empty_cache()
    dlrm["cuda_vs_cpu_step"] = compare_dlrm_step(rng)
    laps.to("dense")
    dense, dense_launches = run_dense_path()
    log("dense update path: %s" % json.dumps(dense))
    # the checkpoint phase draws from its own generator, so every later
    # phase sees the data it saw before it was added
    laps.to("checkpoint")
    with tempfile.TemporaryDirectory() as workdir:
        checkpoint, ckpt_launches, ckpt_job = checkpoint_phase(
            np.random.RandomState(14), workdir, early=early.ckpt)
        log("checkpoint phase launches: %s" % ckpt_launches)
        torch.cuda.empty_cache()
        laps.to("master_worker")
        master_worker, mw_launches = master_worker_phase(ckpt_job, workdir)
        torch.cuda.empty_cache()
        laps.to("lifecycle")
        lifecycle, life_launches = lifecycle_phase(specs, ckpt_job, workdir)
    torch.cuda.empty_cache()
    laps.to("serving_modes")
    with tempfile.TemporaryDirectory() as workdir:
        serving_modes = serving_modes_phase(specs, int8_streams, workdir)
    torch.cuda.empty_cache()
    # phase 26 draws from its own generator, so every earlier phase sees
    # the data it saw before it was added
    laps.to("host_embedding")
    with tempfile.TemporaryDirectory() as workdir:
        host_embedding, host_launches = host_embedding_phase(
            np.random.RandomState(HOST_SEED), workdir)
    torch.cuda.empty_cache()
    laps.to("serving_wire")
    serving_wire, wire_launches = serving_wire_phase(
        specs, bf16_streams, serving["tokens_per_s"])
    serving_wire["stall_bundles"] = _no_stalls("serving_wire")
    torch.cuda.empty_cache()
    verify_entry = time_verify_tile({"paged_decode": serving_modes[
        "speculative_self_draft"]["launches"]["paged_split"]})
    # phase 28 draws from its own generator (TIERS_SEED)
    laps.to("serving_tiers")
    serving_tiers, tiers_launches, tiers_errs = serving_tiers_phase()
    serving_tiers["stall_bundles"] = _no_stalls("serving_tiers")
    torch.cuda.empty_cache()
    # phase 29 draws from its own generator (ROUTER_SEED)
    laps.to("serving_router")
    serving_router, router_launches, router_errs = serving_router_phase()
    serving_router["stall_bundles"] = _no_stalls("serving_router")
    torch.cuda.empty_cache()
    # phase 30 draws from its own generator (TIER_SEED)
    laps.to("serving_router_tier")
    serving_router_tier, tier_launches, tier_errs = (
        serving_router_tier_phase())
    serving_router_tier["stall_bundles"] = _no_stalls("serving_router_tier")
    torch.cuda.empty_cache()
    # phase 31 draws from its own generators (TAB_SEED)
    laps.to("tabular_zoo")
    with tempfile.TemporaryDirectory() as workdir:
        tabular_zoo, tab_launches, tab_errs = tabular_zoo_phase(workdir)
    torch.cuda.empty_cache()
    # phase 32 draws from its own generators (VIS_SEED)
    laps.to("vision_zoo")
    with tempfile.TemporaryDirectory() as workdir:
        vision_zoo, vis_launches = vision_zoo_phase(
            workdir, quickstart=early.quickstart)
    torch.cuda.empty_cache()
    # phase 33 draws from its own generators (ENC_SEED)
    laps.to("encoder_zoo")
    with tempfile.TemporaryDirectory() as workdir:
        encoder_zoo, enc_launches = encoder_zoo_phase(
            workdir, iris_job=early.iris)
    torch.cuda.empty_cache()
    # phase 34 serves phase 16's requests; phase 35 again, over its model
    laps.to("metrics_plane")
    mp_model = TransformerLM(device="cuda", seed=0, **FLAGSHIP)
    metrics_plane, mp_launches = metrics_plane_phase(
        specs, model=mp_model, early=early.metrics)
    metrics_plane["stall_bundles"] = _no_stalls("metrics_plane")
    laps.to("runtime_health")
    runtime_health = runtime_health_phase(mp_model, specs,
                                          seats=early.seats)
    del mp_model
    torch.cuda.empty_cache()
    laps.to("kernels")
    kernels, paged_cases = time_kernels(gen, launches, flash_err, paged_err)
    kernels[0]["launches_int8_serving"] = int8_launches["flash_fwd"]
    kernels[0]["bf16_instances_checked"] = fwd_instances["instances"]
    kernels += time_paged_int8(
        paged_cases, int8_launches, {"max_abs_err": int8_err[0],
                             "max_err": int8_err[0],
                             "max_rel_err": int8_err[1],
                             "path_shape_max_rel_err": int8_err[2]})
    kernels[0]["launches_training_per_step"] = (
        train_launches["flash_fwd"] // TRAIN_STEPS)
    kernels += time_backward(gen, train_launches, bwd_err)
    kernels += time_embedding_kernels(dlrm_launches, gather_err, row_err,
                                      uniform_batch, grouped_sweep)
    for entry in kernels[-4:]:
        entry["launches_per_train_step"] = (
            dlrm["launches_per_step"][entry["name"]])
    # the one-table entries time the kernels the grouped wrappers launch
    # on the DLRM path: their launches are the kernel's, by either wrapper
    for entry, grouped in zip(kernels[-4:-2], DLRM_KERNELS):
        entry["launches_by_wrapper"] = {
            entry["name"]: dlrm_launches[entry["name"]],
            grouped: dlrm_launches[grouped]}
        entry["launches"] = sum(entry["launches_by_wrapper"].values())
    kernels += time_dense(dense_launches)
    for entry in kernels[-len(DENSE_RULES):]:
        entry["small_shapes_max_rel_err"] = dense_err
        entry["chunk_edges_max_rel_err"] = dense_edges
    # each masked variant's launches are those of its own path's run:
    # the windowed training run, the packed family's run, the windowed
    # serving runs (bf16 and int8 arenas)
    masked_launches = {}
    for name in TRAINING_KERNELS:
        masked_launches[name + "_window"] = win_train_launches[
            name + "_window"]
        masked_launches[name + "_segments"] = family_launches[
            name + "_segments"]
    for name in serving_kernels("", WINDOW)[1:]:
        masked_launches[name] = win_launches[name]
    for name in serving_kernels("int8", WINDOW)[1:]:
        masked_launches[name] = win_int8_launches[name]
    flash_errors = {v: dict(e, small_shapes=masked_err.get(v))
                    for v, e in masked_path_err.items()}
    masked = time_masked_flash(masked_inputs, masked_launches, flash_errors)
    for entry in masked:
        if entry["name"].endswith("_window"):
            entry["launches_per_train_step"] = entry["launches"] // TRAIN_STEPS
        else:
            entry["launches_per_train_step"] = (
                entry["launches"] // PACKED_STEPS)
            entry["launches_packed_flagship_ragged"] = (
                packed_flagship_launches["ragged"][entry["name"]])
            entry["launches_packed_flagship_packed4"] = (
                packed_flagship_launches["packed4"][entry["name"]])
    masked[0]["launches_windowed_serving"] = win_launches["flash_fwd_window"]
    masked[0]["launches_windowed_int8_serving"] = (
        win_int8_launches["flash_fwd_window"])
    kernels += masked
    kernels += time_masked_paged(masked_paged_cases, masked_launches,
                                 masked_paged_err)
    for entry in kernels:
        if entry["name"].startswith("paged_decode"):
            entry["sweep_max_rel_err"] = paged_sweep[
                "int8" if "_int8" in entry["name"] else "bfloat16"]
            entry["sweep_max_rel_err_fp32_arenas"] = paged_sweep["float32"]
    kernels += time_offset_flash(
        offset_inputs, sp_launches,
        {v: dict(e, small_shapes=offset_err.get(v))
         for v, e in offset_path_err.items()})
    for entry in kernels:
        if entry["name"] in TRAINING_KERNELS:
            entry["launches_checkpoint_phase_per_step"] = ckpt_launches[
                "training_per_step"][entry["name"]]
        if entry["name"] in SERVING_KERNELS:
            entry["launches_checkpoint_phase_serving"] = ckpt_launches[
                "serving"][entry["name"]]
        if entry["name"] in TRAINING_KERNELS:
            entry["launches_master_worker"] = mw_launches[entry["name"]]
            # phase 20's mesh runs, one step summed over the four ranks:
            # the flagship's causal ring on dp 2 x sp 2 and BERT-base's
            # non-causal ring at d 64 (C and D: the grad_f32 instances)
            for run in ("dp_sp", "bert_dp_sp"):
                entry["launches_%s_per_step" % run] = sp[run][
                    "launches_per_step"].get(entry["name"], 0)
    for name, entry in (("paged_decode", kernels[1]),
                        ("paged_decode_tile", kernels[2])):
        check(entry["name"] == name, "kernels[%d] is %s" % (
            kernels.index(entry), entry["name"]))
        entry["launches_serving_modes"] = {
            mode: m["launches"]["paged_split" if name == "paged_decode"
                                else "paged_tile"]
            for mode, m in serving_modes.items()
            if "launches" in m and not m["kv_cache_dtype"]}
    kernels[0]["launches_serving_modes"] = {
        mode: m["launches"]["flash_fwd"]
        for mode, m in serving_modes.items() if "launches" in m}
    # phase 25's launches by part: a step's under remat and LoRA, the
    # worker's, the export's serving runs, beam search, distillation and
    # speculative decode
    for entry in kernels:
        name = entry["name"]
        if name in TRAINING_KERNELS:
            entry["launches_lifecycle"] = {
                part: [step[name] for step in steps]
                for part, steps in life_launches.items()
                if isinstance(steps, list)}
            entry["launches_lifecycle"]["distill"] = life_launches[
                "distill"][name]
        if name in ("flash_fwd", "paged_decode", "paged_decode_tile"):
            key = {"flash_fwd": "flash_fwd", "paged_decode": "paged_split",
                   "paged_decode_tile": "paged_tile"}[name]
            entry.setdefault("launches_lifecycle", {}).update({
                part: counts[key] for part, counts in life_launches.items()
                if part.startswith("serving_")})
    kernels[0]["launches_lifecycle"].update({
        part: life_launches[part]["flash_fwd"] for part in (
            "beam", "speculative_mismatched", "speculative_warm_start",
            "speculative_distilled")})
    kernels.append(verify_entry)
    # phase 26's E and F launches, run by run, and the errors of its
    # checked steps' launches against their plain versions (the kernels'
    # timings are phase 13's)
    held = host_embedding["scale"]["held_to_plain"]
    for entry in kernels:
        name = entry["name"]
        if name in HOST_KERNELS:
            entry["launches_host_embedding"] = {
                run: counts[name] for run, counts in host_launches.items()}
        if held.get(name):
            entry["host_embedding_max_abs_err"] = max(held[name])
            for key in ("max_abs_err", "max_err"):
                if key in entry:
                    entry[key] = max(entry[key], max(held[name]))
    # phase 27's launches of A and B through the replica's transport
    for entry in kernels:
        if entry["name"] in SERVING_KERNELS:
            entry["launches_serving_wire"] = wire_launches[entry["name"]]
    # phase 28's launches of A and B by part, and the errors of its
    # checked launches against their plain versions
    for entry in kernels:
        name = entry["name"]
        if name in TIERS_KERNELS:
            entry["launches_serving_tiers"] = {
                part: counts[name] for part, counts in tiers_launches.items()}
        if tiers_errs.get(name):
            entry["serving_tiers_max_abs_err"] = max(tiers_errs[name])
            for key in ("max_abs_err", "max_err"):
                if key in entry:
                    entry[key] = max(entry[key], max(tiers_errs[name]))
    # phase 29's launches of A and B in this process's replicas on the
    # routed path, and the errors of its replayed launches against their
    # plain versions
    for entry in kernels:
        name = entry["name"]
        if name in ROUTER_KERNELS:
            entry["launches_serving_router"] = router_launches[name]
        if router_errs.get(name):
            entry["serving_router_max_abs_err"] = max(router_errs[name])
            for key in ("max_abs_err", "max_err"):
                if key in entry:
                    entry[key] = max(entry[key], max(router_errs[name]))
    # phase 30's launches of A and B in this process's replicas on the
    # router tier's path, and the errors of its replayed launches
    for entry in kernels:
        name = entry["name"]
        if name in ROUTER_KERNELS:
            entry["launches_serving_router_tier"] = tier_launches[name]
        if tier_errs.get(name):
            entry["serving_router_tier_max_abs_err"] = max(tier_errs[name])
            for key in ("max_abs_err", "max_err"):
                if key in entry:
                    entry[key] = max(entry[key], max(tier_errs[name]))
    # phase 31's launches of E through embedding_column (by wrapper; the
    # grouped wrapper launches the kernel for one table), its errors
    # against the plain version, and E timed at that path's shape
    for entry in kernels:
        name = entry["name"]
        if name in TAB_KERNELS:
            entry["launches_tabular_zoo"] = tab_launches
            entry["tabular_zoo_max_abs_err"] = max(tab_errs)
        if name == "embedding_gather":
            entry["tabular_zoo_timing"] = dict(
                tabular_zoo["embedding_column"]["gather_timing"],
                shape="%s ids into a %d x %d fp32 table" % (
                    tabular_zoo["embedding_column"]["ids"],
                    tabular_zoo["embedding_column"]["rows"], TAB_EMB_DIM))
    # A, C and D at phase 33's path shapes (bert, vit: d 64, not causal)
    kernels += time_encoder_kernels(enc_launches)
    for entry in kernels:
        if entry["name"] in ("flash_bwd_dq_vit", "flash_bwd_dkv_vit"):
            entry["ragged_check"] = dict(
                vit_bwd["ragged"]["errors"][entry["name"][:-len("_vit")]],
                l=VIT_RAGGED_L, limit_rel=vit_bwd["ragged"]["limit_rel"])
            entry["repeat_bit_equal"] = vit_bwd["repeat_bit_equal"]
        if entry["name"] == "flash_fwd_vit":
            entry["vit_check"] = dict(vit_fwd, limit_rel=FWD_F32_TOL_REL)
            entry["bound_share"] = entry["bound_ms"] / entry["ms"]
    # phase 32's launches: none of the port's kernels runs on the vision
    # zoo's path (conv, BatchNorm and pooling are cuDNN / aten calls)
    for entry in kernels:
        entry["launches_vision_zoo"] = vis_launches.get(entry["name"], 0)
    # phase 33's launches of every kernel by part (A, C and D 12 a layer
    # stack pass; the entries timed at an encoder's shape count their
    # kernel's)
    for entry in kernels:
        name = entry["name"]
        for family in ENC_MODELS:
            if name.endswith("_" + family):
                name = name[:-len(family) - 1]
        entry["launches_bert_vit"] = {
            part: counts.get(name, 0) for part, counts in enc_launches.items()}
    # phase 34's launches of A and B in this process, plane off and on
    for entry in kernels:
        if entry["name"] in SERVING_KERNELS:
            entry["launches_metrics_plane"] = {
                part: counts[entry["name"]]
                for part, counts in mp_launches.items()}
    laps.to(None)
    lines = {"serving": serving, "training": training, "dlrm": dlrm,
             "dense": dense, "packed": packed, "windowed": windowed,
             "sp": sp, "checkpoint": checkpoint,
             "serving_modes": serving_modes, "master_worker": master_worker,
             "lifecycle": lifecycle, "host_embedding": host_embedding,
             "serving_wire": serving_wire, "serving_tiers": serving_tiers,
             "serving_router": serving_router,
             "serving_router_tier": serving_router_tier,
             "tabular_zoo": tabular_zoo, "vision_zoo": vision_zoo,
             "encoder_zoo": encoder_zoo, "metrics_plane": metrics_plane,
             "runtime_health": runtime_health}
    for name, line in lines.items():
        line["card"] = smi
        line["phase_s"] = laps.secs[name]
    # the kernels line keeps its one key: its checks' and timings'
    # seconds ride in the serving_modes line with the whole script's
    serving_modes["kernels_phase_s"] = laps.secs["kernels"]
    serving_modes["early_children_settle_s"] = early.settle_s
    serving_modes["early_children_ready_s"] = early.ready_s
    serving_modes["script_s"] = time.perf_counter() - t_script
    # from the process's first line, its imports (and the build's start
    # beside them) included
    serving_modes["process_s"] = time.perf_counter() - _T0
    log("phase seconds: %s; the whole script %.1f s" % (
        json.dumps(laps.secs), serving_modes["script_s"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(json.dumps({"dlrm": dlrm}))
    print(json.dumps({"dense": dense}))
    print(json.dumps({"packed": packed}))
    print(json.dumps({"windowed": windowed}))
    print(json.dumps({"sp": sp}))
    print(json.dumps({"checkpoint": checkpoint}))
    print(json.dumps({"serving_modes": serving_modes}))
    print(json.dumps({"master_worker": master_worker}))
    print(json.dumps({"lifecycle": lifecycle}))
    print(json.dumps({"host_embedding": host_embedding}))
    print(json.dumps({"serving_wire": serving_wire}))
    print(json.dumps({"serving_tiers": serving_tiers}))
    print(json.dumps({"serving_router": serving_router}))
    print(json.dumps({"serving_router_tier": serving_router_tier}))
    print(json.dumps({"tabular_zoo": tabular_zoo}))
    print(json.dumps({"vision_zoo": vision_zoo}))
    print(json.dumps({"encoder_zoo": encoder_zoo}))
    print(json.dumps({"metrics_plane": metrics_plane}))
    print(json.dumps({"runtime_health": runtime_health}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sp-rank"]:
        sp_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--ckpt-run"]:
        target = sys.argv[3]
        if target.startswith("gate:"):  # started early: the go names it
            target = _gate(target[len("gate:"):], "ckpt")
        ckpt_run_main(int(sys.argv[2]), target)
        sys.exit(0)
    if sys.argv[1:2] == ["--router-replica"]:
        sys.exit(router_replica_main(sys.argv[2], sys.argv[3:]))
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print("chip_smoke FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
