#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line (``"phase": ...``, with ``t_s``, the
seconds since the script started, when the line was printed):

1. device     — the card, its capability (Hopper, 9.0 required) and the
   ``nvidia-smi`` name and power limit (also printed raw on a line of its own);
2. build      — builds every kernel of the port from the checkout's sources,
   then a ``ptxas`` line: registers, static shared memory and spills of each
   kernel of the tensor-core, scan, scan-backward and probe sources
   (``PTXAS_SOURCES``);
3. kernels    — holds each kernel against its plain PyTorch version on the
   card at the qwen3 serve path's shapes, with the stated tolerances, and
   times the kernel, the plain version and (where one exists) one PyTorch
   library call computing the same function, beside the least time the card
   could take; flash's fp32 route (``flash_f32``) at the same decode and
   forward shapes in fp32; the speculative verify's route
   (``flash_verify``, 8 slots x 4 rows) also bit for bit against 4 decode
   launches at pos + t, and the probe over the verify's 32 logit rows;
4. serve      — full-width qwen3-1.7b (28 layers, bf16, seeded random
   weights) served by ``Replica(window=8, overlap=True, num_slots=8,
   max_len=1024)``: the first 10 of 16 requests with 16–256-token prompts
   and 64 new tokens each (cut from 16 when the train phase came, for the
   run's time; two freed slots are still refilled). Every request must be answered OK, the kernels' launch counts must
   show the path went through them, and one answer is held against the
   prefill step's forward. The clean run counts its host syncs by site
   with torch's sync debug mode: every one must lie in
   ``core/device_channel.py::readback`` (none in ``serve/replica.py`` or
   ``models/``), and the line reports every site with its count;
5. lflr       — the same traffic again with a NaN injected into an active
   slot's KV cache mid-run: the probe kernel must latch NONFINITE_LOSS, and
   every stream must be bit-equal to phase 4. The same faulted traffic
   then runs again through a fresh replica with a
   ``repro_torch.obs.Tracer``: the untraced run's streams, fault words,
   recovery actions, kernel launches and host syncs (exactly 2 per window
   plus one history readback per faulted window), the trace's
   ``validate()`` empty, one fault event per attributed slot of each fault
   record with its word and action, the poisoned slot's carrying
   NONFINITE_LOSS, each fault closed by a recovered recovery span; the line
   adds the event count and ms per window step of the two faulted runs,
   traced and untraced (reported, not gated);
6. engines    — qwen3-1.7b through the reference's three unpaged engines
   on one traffic (6 requests, 8–32-token prompts, 12 new tokens; 8 before
   the fuzz phase came, cut for the run's time):
   stepwise (``window=0``), decode windows with blocking prefill
   (``window=8, overlap=False``) and with overlapped prefill. The three
   streams must be equal token for token, host syncs at most 2 per step or
   window plus 2 per blocking prefill, and kernel launches one slot step per
   decode step and per prefilled token;
7. lflr_stepwise, lflr_blocking — the stepwise and the blocking engine on
   the same traffic with one KV fault: streams bit-equal to that engine's
   clean run;
8. serve_paged, lflr_paged — phases 4 and 5 through the page pool
   (``paged=True``, pages of 16, the default 8 × 64 pages): the streams
   must equal phase 4's token for token, at 2 host syncs per window and the
   same launches per step; every page comes back at drain and the ledger is
   consistent. The line adds the pool's size and the device time of one
   whole-tree gather + scatter beside its bytes bound. The NaN goes into
   the lane's first pool page, and the streams must be bit-equal. Both run
   the first 6 requests (cut from 16 to 10 when the traced and fuzz phases
   came, and to 6 when the LayerNorm architectures' phases came, for the
   run's time);
9. page_fault — the same run, on the first 8 requests, with one decoding
   lane's page-table row unmapped mid-run: PAGE_FAULT raised at the wait on
   that slot, one ``page_reclaim`` record, every stream equal to phase 4's;
10. paged_pressure — the first 8 requests through a pool of 64 pages:
   lanes are preempted back into the queue (evictions > 0), the pool's
   peak stays within it, and the streams equal phase 4's;
11. engines_paged — the engines traffic through the blocking engine over
   the pool (``window=8, overlap=False, paged=True``): streams equal the
   blocking engine's, syncs within its rule;
11a. serve_spec, lflr_spec, serve_spec_paged — phases 4, 5 and 8 through
   the speculative windows (``speculate=True, draft_len=3,
   draft_layers=1``): the streams equal phase 4's token for token, at 2
   host syncs a window; a step launches the decode kernel 3 times (the
   draft), the verify route once per layer and the probe once. Each line
   adds the drafts accepted and rejected and serve's ms per step beside
   its own; no fault record carries DRAFT_REJECT; all three run the first
   6 requests (serve_spec_paged cut to 8 when the group phases came,
   serve_spec and lflr_spec to 10 when the traced and fuzz phases came,
   all to 6 when the LayerNorm architectures' phases came, for the run's
   time);
11b. serve_spec_deep — the seeded init makes qwen3 repeat its input token
   at every exit depth, so the drafts above all match: with the embedding
   drawn at a tenth of its scale, the engines traffic through the overlap
   engine and the speculative one drafting from 27 layers gives equal
   streams and drafts both accepted and rejected (one phase at least
   must);
11c. group, group_kill, group_soft, group_replay — the first 6 requests of
   phase 4's traffic through ``ServeGroup(cfg, 3, model=model,
   config=EngineConfig(window=8, num_slots=8, max_len=1024))``: three
   replicas of the qwen3 model, rank threads over the paper's host
   protocols. Clean: every stream equals phase 4's, every rank answers, 2
   host syncs per retired window summed over the ranks. Rank 1 killed at
   round 2: the survivors shrink once to 2 ranks, re-route its requests
   and answer everything with phase 4's streams. A NaN in rank 0's KV at
   round 2: one fault record on rank 0, no shrink, no re-route, phase 4's
   streams. The fleet stopped at round 18 with a write-ahead log, then a
   fresh group with a spare restarts from the log and summons the spare:
   the answered requests come back from their ``retire`` records, the rest
   with phase 4's streams. Each line prints rounds, the median ms per
   round, fleet tokens/s and requests per rank, and device memory before
   and after; any rank that failed, or died unscheduled, fails the run.
   group_kill and group_replay run with ``trace=True``: ``validate()``
   empty over the kill's trace and over the crash's and the restart's
   merged; the kill's chain replica_kill → ulfm_shrink (ranks 0 and 2) →
   reroute for each re-routed request, answered OK where it went, and the
   dead rank's events in the merged trace; every rank's fleet_stop, then
   the restart's ledger_replay, replica_join and completed state_transfer;
11d. fuzz — on the qwen3 model still loaded, the reference corpus entries
   of ``FUZZ_ENTRIES`` (one per single-replica engine: stepwise, window,
   overlap, overlap_paged, spec, spec_paged; JSON read from
   ``tests/fuzz_corpus``) replay through ``repro_torch.fuzz`` with the
   kits built over the full-width model on the card (2 slots, windows of
   4): zero violations (complete, bit-exact against the kit's clean run,
   the page ledger, the trace's ``validate()``, no wedge), every answer OK
   or FAILED, each kit's clean run bit-equal on a second call; the line
   reports the cells each entry covered;
11e. multihost, multihost_kill — after the fuzz phase, the first 10
   requests of phase 4's traffic through ``MultiHostSupervisor(3,
   backend="replica", width="full", device="cuda")``: three worker
   processes (``python -m repro_torch.serve.multihost``), each building
   qwen3-1.7b at full width from serve's seed with serve's engine, under
   the heartbeat supervisor (1 s lease) over localhost sockets. Clean:
   every stream equals phase 4's, nothing evicted or re-routed, every
   worker's ``bye`` word 0 and its launches through ``flash_decode`` (a
   multiple of 28) and ``probe_rows``, the merged trace's ``validate()``
   empty; the line reports wall, fleet tokens/s beside ``group``'s, each
   worker's seconds from spawn to ``hello``, suspicions and the card's
   peak memory by ``nvidia-smi``. Kill: the same requests with staggered
   budgets, 8 + 6 i new tokens for id i (``MULTIHOST_KILL_NEW``, as the
   reference's multi-host test staggers them); worker 1 SIGKILL'd at the
   first retirement fleet-wide (``MULTIHOST_KILL_AT``): evicted within 2 s of
   the kill, its requests re-routed, epoch >= 1, every stream phase 4's cut
   to its budget; what the
   survivors computed after the kill (their workers' trace): each runs a
   decode window that starts after the kill and ends before the eviction,
   and one retires, before the eviction, a request whose last committing
   window started after the kill; the trace's host_kill →
   host_suspect → host_evict → ulfm_shrink → reroute → epoch chain and
   ``rank_failed`` from the survivors only, whose ``bye`` words carry
   RANK_FAILED; the line adds the detection times. The kernels line counts
   the workers' ``bye`` launches (a killed worker's are lost with it);
11f. elastic — ``elastic_train(4, steps=25, lr=0.2)`` with a NaN gradient
   on rank 2 at step 5 and rank 1 killed at step 8, on the card and on the
   CPU: the same events, steps and world sizes, weights within rtol 1e-5,
   final losses under 5e-2 (seconds, no kernel: a 16-dim regression);
11g. train — on the qwen3 model still loaded (after the fuzz phase): the
   train path's kernels at its shapes first — the flash forward with its
   row lse at B 4 x S 256 (16/8 heads, D 128, causal) against the plain
   lse (a control with one key dropped must exceed the limit) and bit-equal
   in its output to the launch without lse, FlashAttention's dq/dk/dv
   against autograd through the plain version in fp32 (a control against
   the mask shifted by one key must exceed the limit), the probe over the
   151936 x 2048 bf16 embedding gradient (one row), and ``probe_tree``
   over a tree of full-width qwen3's 310 gradient leaves (their shapes and
   dtypes, 3.44 GB, drawn on the card; one leaf a view at an odd element
   offset) bit-equal to ``probe_tree_ref`` clean, with a NaN in the last
   element of the last leaf, an overflow in the first of the first leaf
   and a -inf in the first of the misaligned leaf — each timed. Then three runs of
   12 steps of ``ResilientExecutor`` over ``make_train_step`` at B 4 x S
   256, each from a fresh copy of the serving model's weights with zero
   moments (the model itself unchanged), a snapshot every 5 steps, no
   checkpointer: clean — every step ok, exactly one host sync a step (the
   port's counter and torch's sync debug mode), ``flash_forward`` 28
   launches a step and one ``probe_tree`` launch over all 310 gradient
   leaves (no ``probe_rows``, no leaf copied for being non-contiguous),
   finite losses;
   faulted — nan_grad at 3, bad_data at 5, spike_loss at 7, nan_loss at 9
   give ``TRAIN_FAULT_EVENTS`` (skip, restore, optimizer reset, rollback),
   the list the CPU tests get from the JAX executor; LFLR — nan_grad at 3
   and 8 (skip, restore to the snapshot after step 5) ends ``torch.equal``
   on every leaf with a clean run over the kept batches. The line reports
   ms per step, tokens/s, a snapshot's ms, the state's and the peak GB, the
   losses and the phase's seconds. No checkpoint of the 17 GB state is
   written (the card tests hold the ``Checkpointer`` at smoke width);
12. kernels_rg — the same checks and timings at recurrentgemma-2b's shapes:
   the RG-LRU scan at (2, 4096, 2560) with a control (one step's log_a
   halved) that must exceed the limit, and again on long-memory log_a,
   where a control in chunk 0 must exceed it after chunk 1; the scan's
   backward (``rglru_scan_bwd``) at that shape, at the train shape (4 x
   256 x 2560) and at the microbatch's (2 x 256 x 2560; one pass, chunks
   handed on by ticket) against its plain
   reverse loop, a control (one step's log_a halved) outside the limit, two
   launches bit-equal, the forward's states
   it reads held to the plain scan at each shape, and on long-memory
   log_a with a control in the last chunk that must exceed the limit over
   the chunks before the last two; flash decode
   over ring caches that wrap, the sliding-window flash forward at S 4096,
   the probe over the recurrent state and over the prefill logits;
13. serve_rg   — phase 4 for full-width recurrentgemma-2b (26 layers: 18
   RG-LRU, 8 sliding-window attention; bf16, seeded random weights), the
   qwen3 model freed first, on the first 6 requests (cut from 16 to 10 when
   the traced and fuzz phases came, and to 6 when the LayerNorm
   architectures' phases came, for the run's time);
14. lflr_rg   — phase 5 for recurrentgemma-2b, on the same 6 requests: the
   NaN goes into the slots' recurrent state and the state probe must latch
   STATE_FAULT;
15. lflr_stepwise_rg — recurrentgemma's stepwise engine, 4 requests, clean
   and with a NaN in ``h``: the re-prefill rebuilds the lane across the
   state's (batch, layer) layout, and the streams are bit-equal;
16. prefill_rg — ``make_prefill_step`` at B 2, S 4096 (twice the sliding
   window): the scan kernel once per RG-LRU layer, flash once per sliding
   layer, one probe, a clean word, its time and peak memory;
16a. train_levers — the train step's ``microbatch`` and ``ce_chunk``
   levers on recurrentgemma-2b at its published width cut to one period
   (``LEVERS_LAYERS``, 3 layers), B 4 x S 256, one state and one batch:
   the flash lse forward and FlashAttention's gradients at the
   microbatch's one row, then the loss and gradients of ``microbatch=4,
   ce_chunk=64`` and of ``ce_chunk=96`` (a ragged last chunk) within
   ``TRAIN_GRAD_TOL`` of the plain step's, another batch's gradients as
   the control; one step of each: word 0, flash's lse route, the scan and
   its backward launched k times the plain step's, ``probe_tree`` once;
   ``nan_grad`` and ``bad_data`` under the levers give the plain step's
   words;
16b. train_rg — phase 11g's kernel checks, clean and LFLR runs for
   recurrentgemma-2b at its published width cut to ``TRAIN_RG_LAYERS`` (18
   of 26: six periods of RG-LRU, RG-LRU, sliding; 2.06 G parameters), the
   step built with the levers (``TRAIN_MICROBATCH`` 2, ``TRAIN_CE_CHUNK``
   128), from a fresh seeded model's weights copied to the host (the model
   freed before the runs, so the train states are alone on the card): the
   flash forward with lse and FlashAttention's gradients at 10/1 heads of
   D 256, window 2048, at the microbatch's rows, the probe over the 256000
   x 2560 embedding gradient and ``probe_tree`` over the model's 200
   gradient leaves (the fp32 ``lam`` among them); then one host sync a
   step, per step the scan and its backward 12 x 2 times each, the flash
   forward 6 x 2 times and one ``probe_tree``; finite losses; the LFLR run
   bit-equal to a clean run over the kept batches; the peak under
   ``TRAIN_PEAK_GB``; the line's ``mfu`` (6 N D over the median step at
   the card's dense bf16 peak) and the dry run of the same step
   (``launch/dryrun.py``, run beside the card in a process of its own from
   the start): its FLOPs, and its peak within 2x of the measured one. The
   faulted run and the profile are qwen3's alone (the decisions do not
   depend on the architecture; the CPU tests hold every stack's to the
   reference);
17. kernels_ssm — the SSD intra-chunk kernel and the whole scan at
   mamba2-2.7b's prefill shape and at a shape with groups over heads and
   fewer steps than the chunk (bf16: the tensor-core route), and at the
   prefill shape in fp32 (the ``ssd_f32`` route), and at the train shape
   (4 x 256, nc 2) and the microbatch's (2 x 256), each with a control
   that must exceed the limit (one step's dt changed); the SSD backward
   (``ssd_chunk_bwd``) at the prefill, the train and the microbatch's
   shapes in bf16 (``ssd_chunk_bwd_tc``, the tensor
   cores) and at the train shape in fp32 (``ssd_chunk_bwd_f32``), each row
   naming the route ``plan_bwd`` picked, against autograd through the plain
   intra-chunk function, with its control and two launches bit-equal; and
   the probe over the full ``ssm`` state;
18. serve_ssm  — phase 4 for mamba2-2.7b at full width cut to
   ``SSM_SERVE_LAYERS`` (32 of its 64 SSD layers, since the encoder's and
   the VLM's train phases came, for the run's time; bf16, seeded random
   weights), the recurrentgemma model freed first, on the
   first 6 of the 16 requests (cut to 8 when the paged phases came and to
   6 when the MoE phases came, to keep the run's time);
19. lflr_ssm   — phase 5 for mamba2-2.7b: the NaN goes into the slots'
   ``ssm`` state and the state probe must latch STATE_FAULT;
20. prefill_ssm — ``make_prefill_step`` at B 2, S 4096: the SSD tensor-core
   kernel once per layer, one probe, a clean word, its time and peak memory;
20a. train_ssm — phase 16b for mamba2-2.7b cut to ``TRAIN_SSM_LAYERS`` (48
   of 64 layers, 2.06 G parameters; no attention, so the probes' checks
   alone, ``probe_tree`` over its 578 leaves): per step the SSD
   tensor-core kernel and its tensor-core backward 48 x 2 times each and
   one ``probe_tree``;
21. kernels_g3 — flash and the probe at gemma3-1b's shapes (4/1 heads of
   256): decode over the full cache and over the 512-entry ring, wrapped,
   the sliding (window 512) and the full forward at 2 × 4096, the probe
   over 8 × 262144 logits, each flash row with controls;
22. serve_g3   — phase 4 for full-width gemma3-1b (26 layers: 22 sliding,
   4 full; bf16, seeded random weights), the mamba2 model freed first, on
   the first 10 requests (cut from 16 when the train phase came; two slots
   refilled); two of the prompts have 560 tokens, so the rings wrap, and
   the longest answer is held against the forward. Its clean run counts
   the host syncs by site with torch's sync debug mode, as phase 4's: every
   one in ``readback``;
23. lflr_g3    — phase 5 for gemma3-1b: the NaN goes into K of layer 5, its
   first full layer, as in the JAX replica;
24. serve_g3_paged, lflr_g3_paged — phases 22 and 23 through the pool, on
   the first 8 requests: the 4 full layers paged, the 512-entry rings
   dense; the streams must equal phase 22's, and the NaN goes into K of
   layer 5, now a pool page;
25. prefill_g3 — ``make_prefill_step`` at B 2, S 4096: flash forward once per
   layer, one probe;
26. kernels_moe — flash decode at qwen3-moe-30b-a3b's head layout (8 slots,
   32/4 heads of 128: group 8, the full 1024-entry cache) against its plain
   version, with its controls, time, bound and the library call's time;
27. serve_moe, lflr_moe — phases 4 and 5 for qwen3-moe-30b-a3b at full
   width cut to ``MOE_SERVE_LAYERS`` (24 of its 48 layers since the
   encoder's and the VLM's train phases came, for the run's time; each
   attention and a 128-expert top-8 MoE with capacity buffers, untied
   unembedding; 31 GB of bf16 weights at 24 layers, 61 GB at 48, seeded on
   the card leaf by leaf), the gemma3 model freed first, on the first 6 requests
   and one with an 8-token prompt (cut from 8 for the run's time, as the
   group phases were): the NaN goes into one MoE layer's K cache, LFLR's
   streams equal the clean run's bit for bit. The MoE forward drops tokens
   past each expert's capacity and the decode (one token a row) never
   does, so the short request's stream is compared with the forward below
   a prefix whose forward drops nothing (found by bisection on the dropped
   fraction, at least 8 served positions). The gate runs first, in fp32,
   on the model cut to 4 layers at full width: the served tokens within
   ``FORWARD_GAP_TOL`` of the forward's argmax and the same experts
   chosen at every layer and position. At the served depth in bf16 routing
   near-ties part the two (reported: where they part, the router's gap
   there, the logit gaps), and the decode loop's argmax must be the served
   stream. The line adds the init's time and peak memory and each run's
   peak;
28. engines_moe — the stepwise and the blocking engine on the short
   request's first 12 tokens: they equal the first 12 of serve_moe's stream
   token for token, syncs and launches by each engine's rule, each run's
   peak memory. The model is freed after.
29. kernels_arch — flash and the probe at the head layouts and vocabularies
   of the LayerNorm and partial-rotary architectures, no model on the
   card: decode over starcoder2-3b's 4096-entry ring (24/2 heads of 128,
   group 12), wrapped past 4096, over chatglm3-6b's cache (32/2, group 16,
   the most a decode block holds) and phi3.5-moe's (32/8); the verify at
   32/2, 8 slots x 4 rows, bit for bit against 4 decode launches; the
   forward at 24/2 with the 4096 window over 2 x 8192 and at 32/2 causal
   over 2 x 4096; the probe over each model's 8 serve logit rows. Each
   flash row has controls that must exceed the limit;
30. serve_sc2, lflr_sc2, serve_glm, lflr_glm, serve_phi, lflr_phi —
   phases 4 and 5 for full-width starcoder2-3b (30 sliding layers with
   4096-entry windows, LayerNorm, plain-GeLU MLP), chatglm3-6b (28 layers,
   the interleaved-pair rotary over 64 of 128 head dims, untied) and
   phi3.5-moe-42b-a6.6b (LayerNorm, 16 experts top-2, cut to 24 of its 32
   layers at its published width: 62.9 GB of bf16 weights, where 32 would
   not fit the card), each seeded alone on the card after the one before
   is freed, on the first 6 requests (chatglm3 and phi3.5-moe with one
   8-token prompt more); the NaN goes into K of layer 0 (for starcoder2 a
   sliding layer's ring: at ``max_len`` 1024 it holds the whole row), and
   LFLR's streams equal the clean run's bit for bit. starcoder2's and
   chatglm3's shortest request is held to the forward; phi3.5-moe's as
   qwen3-moe's, gated in fp32 at 4 layers, reported in bf16.
31. kernels_vlm — flash and the probe at the cross-attention and encoder
   shapes, no model on the card: the cross decode (8 slots, 32/8 heads of
   128, one row over llama-3.2-vision-11b's 1601 image keys, no mask, the
   last tile ragged), the cross forward (2 x 4096 rows over 1601 keys),
   hubert-xlarge's bidirectional forward (2 x 4096, 16/16 heads of 80), the
   self-attention forward (2 x 4096, causal) and decode at 32/8, the probe
   over 8 x 128256 serve logits
   and 8192 x 504 prefill logits. Each flash row has controls that must
   exceed the limit;
32. serve_vlm, lflr_vlm — phases 4 and 5 for full-width
   llama-3.2-vision-11b (40 layers: 32 self-attention and 8 gated cross
   layers, untied; 19.55 GB of bf16 weights), alone on the card, on the
   first 6 requests, no image input (as the JAX replica: each cross layer
   reads the zeros of a fresh cache, gated by tanh(0)): flash decode 40 a
   step, 8 of them over the 1601 image keys; the NaN goes into K of layer
   0, LFLR's streams equal the clean run's bit for bit;
33. forward_check_vlm, prefill_vlm — the cross gates drawn non-zero, two
   rows of seeded image embeddings projected into the cross caches
   (``precompute_cross_kv``), 16 prompt tokens and two decode windows held
   to ``forward(tokens, img_embeds=...)`` within ``FORWARD_GAP_TOL``; then
   ``make_prefill_step`` at B 2, S 4096 with 1601 image embeddings per row:
   flash forward once per layer, one probe; a NaN in row 0's image sets the
   word and leaves row 1's logits finite. The model is freed after;
34. prefill_hubert — full-width hubert-xlarge (48 layers, 1.89 GB) alone
   on the card through ``make_prefill_step`` from 2 x 4096 frame
   embeddings: flash forward once per layer, non-causal at head_dim 80; a
   NaN in one frame of row 0 makes every logit row of that row non-finite
   and leaves row 1's finite. An encoder has no decode: no serve phase;
35. train_hubert, train_vlm — phase 16b for full-width hubert-xlarge (48
   of 48 layers, 0.945 G parameters: frame-embedding batches, no tokens)
   and for llama-3.2-vision-11b cut to ``TRAIN_VLM_LAYERS`` (5 of 40: one
   period of its pattern, 4 self-attention layers and 1 cross, widths as
   published, 2.14 G parameters; batches with 1601 image embeddings a
   row), each from a seeded model whose weights go to the host before the
   runs, the VLM's cross gates set to ``TRAIN_GATE``: the flash forward
   with lse and FlashAttention's gradients at hubert's 16/16 heads of 80,
   non-causal, and at the VLM's 32/8 heads of 128, causal, and over its
   1601 image keys, non-causal; the probes over each embedding's gradient
   and each gradient tree; per step ``flash_forward`` 48 and 5 times and
   one ``probe_tree``, one host sync, finite losses, the LFLR run
   bit-equal, the peak under ``TRAIN_PEAK_GB``; for the VLM, the first
   step's gradient non-zero and finite in each cross layer's wq, wk, wv
   and wo (exactly zero at the seeded gates). The batches are drawn before
   the runs and their draw timed apart;
36. run — the run's seconds so far. Every phase line carries ``seconds``:
   its own, or the time since the line before it.

Then the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Any failure exits non-zero before the last line is printed.
"""
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
import warnings
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
START = time.perf_counter()
SEED = 0
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20             # H100 L2 cache
ROTATE_BYTES = 2 * L2_BYTES         # inputs rotated through per timing run
MAX_COPIES = 48                     # keeps a plain run's launches under the
                                    # device's launch queue (~1000 pending)
SPIN_CYCLES = 5 * 10 ** 7           # ~25 ms at 1.98 GHz: the host's head start
NUM_SLOTS, MAX_LEN, WINDOW = 8, 1024, 8
NUM_REQUESTS, MAX_NEW = 16, 64
# serve, serve_g3 and the multihost phases: two requests more than the
# slots, so that two freed slots are refilled
REFILL_REQUESTS = NUM_SLOTS + 2
LONG_PROMPT = 560                   # gemma3: past its 512-entry rings
SHORT_PROMPT = 8                    # the MoE forward check's extra request
# the engines phases: the three engines of the reference's serving
# benchmark on one short traffic (6 requests, cut from 8 when the fuzz
# phase came, for the run's time; serve_spec_deep's too)
ENGINE_REQUESTS, ENGINE_NEW = 6, 12
ENGINES = {"stepwise": dict(window=0),
           "blocking": dict(window=WINDOW, overlap=False),
           "overlap": dict(window=WINDOW, overlap=True)}
# the paged phases: pages of 16 positions, the default budget (8 slots x
# 64 pages), and a pool of 64 pages for the pressure phase
PAGE_SIZE, PRESSURE_BUDGET = 16, 64
PAGED = dict(paged=True, page_size=PAGE_SIZE)
# the speculative phases: 3 drafts a step from the first layer; the deep
# draft's phase draws the embedding at a tenth of its init scale
SPEC = dict(speculate=True, draft_len=3, draft_layers=1)
SPEC_DEEP_EMBED = 0.1
# the group phases: a fleet of 3 qwen3 replicas with serve's engine on the
# first 6 requests of serve's traffic (cut from 8, which took 104 s of a
# 525 s run: a rank's rounds follow its longest prompt, and the first 6
# drop the 225- and 254-token ones); rank 1 killed, or a NaN in rank 0's
# KV, at round 2; the fleet stopped at round GROUP_CRASH_AT, when the two
# 63-token prompts are answered (round 16) and the rest are not (the next,
# 83 tokens, about round 19)
GROUP_RANKS, GROUP_REQUESTS, GROUP_FAULT_ROUND, GROUP_CRASH_AT = 3, 6, 2, 18
# the multi-host phases: 3 worker processes, each serving qwen3 at full
# width with serve's engine and seed, on serve's first REFILL_REQUESTS
# requests; a 1 s lease (eviction 1.8 s after the last beat); a serve
# timeout that fails a fleet whose worker died at start-up within minutes.
# The kill run staggers the generation budgets, as the reference's own
# multi-host test does (tests/test_serve_multihost.py::mk_staggered):
# request i asks for MULTIHOST_KILL_NEW[0] + MULTIHOST_KILL_NEW[1] * i new
# tokens (8 to 62), and its stream is serve's cut to that budget. Worker 1
# is SIGKILL'd at the first retirement fleet-wide, while all of its own
# requests are still out, and the survivors then retire one request every
# window or so. The gate counts only what the survivors computed after the
# kill: every survivor runs a decode window that starts after the kill and
# ends before the eviction, and a survivor retires a request, before the
# eviction, whose last committing window started after the kill. With
# serve's uniform 64-token budgets that retirement was worker 2's id 8
# alone, 1.11-1.54 s into the 1.8 s window at 38-41 ms serve steps and 22
# ms past the eviction on a slower host: the gate followed the host's speed.
MULTIHOST_RANKS, MULTIHOST_SUSPECT_TIMEOUT, MULTIHOST_TIMEOUT = 3, 1.0, 150.0
MULTIHOST_KILLED, MULTIHOST_KILL_AT, MULTIHOST_KILL_NEW = 1, 1, (8, 6)
# the elastic phase: the card's fp32 gradients against the CPU's
ELASTIC_RTOL = 1e-5
# the MoE phases (qwen3-moe-30b-a3b at full width, last, alone on the card):
# serve's first MOE_REQUESTS requests and one with a SHORT_PROMPT-token
# prompt, all in the slots at once (cut from NUM_SLOTS, as the group phases
# were: the first 6 drop the 225- and 254-token prompts, which set the
# step count, 318 against 200, at ~120 ms a step on an H100, PERF.md §5;
# mamba2's serve phases were cut the same way); the stepwise and blocking
# engines on the short request's first ENGINE_NEW tokens (both prefill its
# prompt token by token at the slots' batch); the served stream compared
# with the forward on at least MOE_FORWARD_MIN positions of a prefix whose
# forward drops no token
MOE_ARCH, MOE_REQUESTS, MOE_FORWARD_MIN = "qwen3-moe-30b-a3b", 6, 8
# the serve paths cut in depth (never in width) for the run's time when the
# encoder's and the VLM's train phases came: qwen3-moe-30b-a3b to 24 of its
# 48 layers and mamba2-2.7b to 32 of its 64 (their serve and LFLR phases
# took 98 and 72 s of a 1076 s run on a slow host); the decode steps are
# host-bound, so their time follows the depth
MOE_SERVE_LAYERS, SSM_SERVE_LAYERS = 24, 32
# the LayerNorm and partial-rotary architectures, last, each alone on the
# card, on MOE_REQUESTS requests (chatglm3 and phi3.5-moe with one short
# request more: its stream held to the forward); phi3.5-moe at its
# published width cut to PHI_LAYERS of 32 layers (all 32: 83.7 GB of bf16
# weights, more than the card; 24: 62.9 GB, about qwen3-moe's footprint)
ARCH_SERVE = ("starcoder2-3b", "chatglm3-6b", "phi3.5-moe-42b-a6.6b")
PHI_LAYERS = 24
# the cross-attention and encoder architectures, last, each alone on the
# card: llama-3.2-vision at full depth (19.55 GB of bf16 weights) served on
# MOE_REQUESTS requests, its decode over filled image K/V held to the
# forward on VLM_PROMPT-token prompts and VLM_WINDOWS decode windows in
# VLM_ROWS rows; hubert-xlarge's prefill from frame embeddings
VLM_ARCH, HUBERT_ARCH = "llama-3.2-vision-11b", "hubert-xlarge"
VLM_ROWS, VLM_PROMPT, VLM_WINDOWS = 2, 16, 2
POISON_AT = (100, 5)                # the prefill NaN gates' (position, channel)
# the MoE forward check's gate runs in fp32, at full width cut to this depth
# (12.5 GB of fp32 weights; the full depth would be 122 GB)
MOE_FP32_LAYERS = 4
SERVE_LINES: dict = {}              # a serve phase's ms per step and tokens/s
FLASH_TOL = 1.6e-2                  # bf16 outputs: 2 ulp at |x| < 2
# flash outputs average over hundreds to thousands of keys (|x| ~ 0.05), so
# every bf16 row is also held, element by element, to 2 bf16 ulps of itself
# plus 1e-4 for values near 0. Kernel and plain version both accumulate in
# fp32 and round once to bf16, so they differ by about 1 ulp; a kernel off
# by one key (at the causal end, a decode split boundary, the window or ring
# edge) is run as a control and must exceed the limit
FLASH_RG_TOL = (1e-4, 2.0 ** -6)    # abs, rel
# fp32 scan: exp/sqrt ulps and FMA contraction differ from the plain
# version's and compound through the recurrence over ~1/(1-a) steps
SCAN_TOL = 1e-4
# the scan's backward against its plain reverse loop: the same rounding
# compounded over the reverse recurrence, the carries folded in another
# order, and dlog_a's two terms of similar size subtracted: 1e-4 of the
# largest |want| plus 1e-4 of each. A control with one step's log_a halved
# must exceed it
SCAN_BWD_TOL = (1e-4, 1e-4)
# the SSD kernel and its plain version both work in fp32 and differ in
# summation order (sums of <= 128 terms): 1e-4 of each element plus 1e-4 of
# the largest. The scan's bf16 output rounds those fp32 results, about 1 ulp
# apart: 2 bf16 ulps of each element. A control with one step's dt doubled
# must exceed the limit
SSD_TOL = (1e-4, 1e-4)              # of the largest |want|, of each |want|
SSD_BF16_TOL = (1e-4, 2.0 ** -6)
# flash's fp32 route against its plain version: summation order only
FLASH_F32_TOL = 2e-5                # abs + rel, as the card tests
FORWARD_GAP_TOL = 2.0               # decode vs forward logits, bf16 and fp32
PREFILL_B, PREFILL_S = 2, 4096      # prefill_32k cut to 1 card: 2x the window
PREFILL_32K = 32768                 # prefill_32k's length, for the scan's timing
# the fuzz phase: one corpus entry per single-replica engine
FUZZ_ENTRIES = ("seed_stepwise_0_01", "seed_window_0_08", "seed_overlap_0_07",
                "seed_overlap_paged_0_03", "seed_spec_0_04", "seed_spec_paged_0_00")

# the train phase: qwen3 at full width, B 4 x S 256 a step, three runs of 12
# steps with a known-good snapshot every 5 steps and no checkpointer
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_GOOD_INTERVAL = 4, 256, 12, 5
# the faulted run's schedule and the events (step, kind, code, action) the
# reference's policy gives for it (straggler events aside):
# tests/test_torch_train.py holds the JAX executor (and the port's) to the
# same list at smoke width
TRAIN_FAULTS = ((3, "nan_grad"), (5, "bad_data"), (7, "spike_loss"), (9, "nan_loss"))
TRAIN_FAULT_EVENTS = (
    (0, "ok", 0, None), (1, "ok", 0, None), (2, "ok", 0, None),
    (3, "fault", 0x2, "skip_batch"),            # NONFINITE_GRAD, transient
    (4, "ok", 0, None),
    (5, "fault", 0x20, "restore_good"),         # DATA_FAULT, the second
    (6, "ok", 0, None),
    (7, "fault", 0x10, "reset_optimizer"),      # DIVERGENCE
    (8, "ok", 0, None),
    (9, "fault", 0x1, "rollback"),              # NONFINITE_LOSS, the fourth
    (10, "ok", 0, None), (11, "ok", 0, None))
# the LFLR run: skip at 3, restore at 8 to the snapshot taken after step 5;
# its state must equal a clean run's over the batches its log kept
TRAIN_LFLR_FAULTS = ((3, "nan_grad"), (8, "nan_grad"))
TRAIN_LFLR_KEPT = (0, 1, 2, 4, 5, 9, 10, 11)
# the divergence threshold of the train phase's probes. build_train_setup's
# is the reference's 50, set for the smoke model (its first loss ~41); under
# the seeded init the tied embedding dominates the residual stream, so at
# d_model 2048 a token's own logit is ~|e|^2 ~ 2000 and the clean loss is
# that order: 1e5 stays above every clean step and far below a spiked one
# (spike_loss multiplies the loss by 1e6)
TRAIN_DIVERGENCE = 1e5
# the recurrent stacks' train phases: each at its published width with the
# train step's levers on (TRAIN_MICROBATCH slices of the batch, the loss in
# sequence chunks of TRAIN_CE_CHUNK), cut to the depth whose reckoned peak
# stays under TRAIN_PEAK_GB with 8 GB to spare. The peak is
# the train states', not the activations' (B 4 x S 256 is 1024 tokens): 10
# B a parameter for the params and the two fp32 moments, three such states
# live at once (the executor's known-good snapshot, the step's input and
# its output), and the fp32 gradient sums, 34 B a parameter: full depth,
# 2.68 G and 2.70 G parameters, would need about 91 GB. So
# recurrentgemma-2b runs 6 whole periods of (RG-LRU, RG-LRU, sliding),
# 2.06 G parameters, and mamba2-2.7b 48 of its 64 layers, 2.06 G (70.15
# and 70.20 GB at microbatch 4, 70.25 and 70.30 at 2: the least k, 2, is
# taken). Every train phase's peak must stay under TRAIN_PEAK_GB (the card
# holds 80 GB)
TRAIN_RG_LAYERS, TRAIN_SSM_LAYERS, TRAIN_PEAK_GB = 18, 48, 80.0
TRAIN_MICROBATCH, TRAIN_CE_CHUNK = 2, 128
# the levers' phase: recurrentgemma-2b at its published width, one period
# (2 RG-LRU layers, 1 sliding), B 4 x S 256 from one state and one batch:
# microbatch 4 with the loss in chunks of 64, and chunks of 96 alone (the
# last chunk ragged: 64 positions and 32 of padding), each against the
# plain step
LEVERS_LAYERS, LEVERS_MB, LEVERS_CE, LEVERS_CE_RAGGED = 3, 4, 64, 96
# the encoder's and the VLM's train phases: hubert-xlarge whole (48 layers,
# 0.945 G parameters), llama-3.2-vision-11b cut to one period of its
# published pattern (4 self-attention layers and 1 cross; 2.14 G parameters,
# 1.05 G of them the untied embedding and unembedding) at its published
# widths, 1601 image tokens a row; the cut phases keep their starting
# weights on the host, so no seeded model stays on the card beside the
# three train states. TRAIN_GATE is what both cross gates are set to after
# the seeded init, in every run: at the init's 0, tanh(0) = 0 gives every
# weight of a cross layer an exactly zero gradient
TRAIN_VLM_LAYERS, TRAIN_GATE = 5, 0.5
# the training forward's row lse against the plain one: fp32 sums in another
# order, exp2 in place of exp (abs, rel); a control with one key dropped
# moves the last row's lse by ~0.04 and must exceed it
LSE_TOL = (1e-5, 1e-5)
# FlashAttention's dq/dk/dv (bf16) against autograd through the plain
# version in fp32 over the same bf16 inputs: 1% of the largest |grad| plus
# 2 bf16 ulps of each — the gradients round to bf16, and delta = sum(do out)
# reads the bf16 out, whose rounding cancels in dp - delta (0.23 of this
# limit on the CPU at the training shape). A control against the mask
# shifted by one key (each row sees the next key) must exceed it
TRAIN_GRAD_TOL = (1e-2, 2.0 ** -6)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_LAST_PHASE = [START]


def emit(obj: dict) -> None:
    """Prints one JSON line; a phase line gains ``t_s`` (seconds since the
    start) and, unless it carries its own, ``seconds`` (since the previous
    phase line: the phase's time, the model builds and checks before it
    included)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {"seconds": now - _LAST_PHASE[0], **obj, "t_s": now - START}
        _LAST_PHASE[0] = now
    print(json.dumps(obj), flush=True)


def copies(make, nbytes: int) -> list:
    """Enough independent copies of one call's inputs (``make()`` builds one,
    of ``nbytes``) that a timing run rotating through them outgrows the L2
    cache: each copy is evicted before its next use, so the inputs come from
    device memory, as on the serve path."""
    n = min(MAX_COPIES, max(2, math.ceil(ROTATE_BYTES / nbytes)))
    return [make() for _ in range(n)]


def time_ms(torch, fn, inputs: list, *, launches: int = 32,
            queued: bool = True) -> float:
    """Mean device time of ``fn(*args)`` over one run of at least
    ``launches`` calls between one CUDA event pair, rotating over ``inputs``.

    A spin kernel queued ahead of the start event holds the device while the
    host queues the whole run, so the wrapper's host work never lands
    between launches. If the device has already passed the start event when
    the last call is queued, the run is repeated with a longer spin.

    ``queued=False`` is for a function that launches more kernels than the
    device queues (the plain scan: one per time step); it is timed without
    the spin, so its time includes the host's launch gaps."""
    for args in inputs:
        fn(*args)
    n = max(launches, len(inputs))
    if not queued:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            fn(*inputs[i % len(inputs)])
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    spin = SPIN_CYCLES
    for _ in range(5):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for i in range(n):
            fn(*inputs[i % len(inputs)])
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / n
        spin *= 4
    fail(f"timing: the host could not queue {n} calls ahead of the device")


FLASH_CSRC = "src/repro_torch/kernels/flash_attention/csrc"


def flash_call(flash_attention, *args, **kwargs):
    """One call of the flash wrapper: its output, and the kernel it launched
    (the one whose count moved) with that kernel's source."""
    before = dict(flash_attention.kernel_launches)
    out = flash_attention(*args, **kwargs)
    moved = [k for k, n in flash_attention.kernel_launches.items() if n != before[k]]
    if len(moved) != 1:
        fail(f"flash_attention launched {moved}, not one kernel")
    source = "flash_decode" if moved[0] == "flash_verify" else moved[0]
    return out, {"kernel": moved[0], "source": f"{FLASH_CSRC}/{source}.cu"}


def flash_excess(got, want) -> float:
    """Largest ``|got - want| / (abs + rel |want|)`` under ``FLASH_RG_TOL``:
    at most 1 passes."""
    atol, rtol = FLASH_RG_TOL
    want = want.float()
    return ((got.float() - want).abs() / (atol + rtol * want.abs())).max().item()


def key_doubled(k, v, j: int):
    """Copies of ``k, v`` with key ``j - 1`` standing in for key ``j``: a
    kernel that counts the key before a split boundary twice and drops the
    one after it."""
    k, v = k.clone(), v.clone()
    k[:, j], v[:, j] = k[:, j - 1], v[:, j - 1]
    return k, v


def scaled_excess(got, want, tol) -> float:
    """Largest ``|got - want| / (a max|want| + r |want|)`` for ``tol = (a,
    r)``: at most 1 passes."""
    a, r = tol
    want = want.float()
    limit = a * want.abs().max() + r * want.abs()
    return ((got.float() - want).abs() / limit).max().item()


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def phase_device(torch) -> str:
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"phase": "device", "name": name, "capability": list(cap),
          "count": torch.cuda.device_count(), "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if cap != (9, 0):
        fail(f"{name} has capability {cap}; the kernels are built for sm_90a")
    return line


PTXAS_SOURCES = ("flash_decode.cu", "flash_forward.cu", "ssd_chunk_tc.cu",
                 "ssd_chunk_bwd_tc.cu", "ssd_chunk_bwd.cu", "rglru_scan.cu",
                 "rglru_scan_bwd.cu", "fault_probe.cu")      # reported by ptxas


def ptxas_report(log: str) -> list:
    """Each kernel instantiation in an ``nvcc -Xptxas -v`` log: its name and
    head_dim (flash's template argument; for flash_decode also whether it is
    the verify's instantiation; the probe's table type), registers, static
    shared memory,
    stack and spills (the flash and SSD kernels' shared memory is dynamic:
    see their sources)."""
    import re
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # _ZN <length><name>... E: the last name is the kernel's, and a
            # template argument ILi<head_dim>E may follow it
            mangled, names, i = m.group(1), [], 3
            while mangled.startswith("_ZN") and i < len(mangled) and mangled[i].isdigit():
                d = re.match(r"\d+", mangled[i:]).group()
                i += len(d)
                names.append(mangled[i:i + int(d)])
                i += int(d)
            hd = re.match(r"ILi(\d+)E(?:Lb([01])E)?", mangled[i:])
            cur = {"kernel": names[-1] if names else mangled,
                   "head_dim": int(hd.group(1)) if hd else None}
            table = re.match(r"IN?S_(\d+)", mangled[i:])  # probe_kernel<RowTable>
            if table:
                cur["template"] = mangled[i + table.end():
                                          i + table.end() + int(table.group(1))]
            if hd and hd.group(2):          # flash_decode's verify flag,
                flag = "lse" if "forward" in cur["kernel"] else "verify"
                cur[flag] = hd.group(2) == "1"   # flash_forward's lse flag
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return rows


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    so = build.build()
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(so, ROOT),
          "sources": [os.path.relpath(s, ROOT) for s in build.sources()]})
    emit({"phase": "ptxas", "kernels": {
        src: ptxas_report(build.compile_log(so, src)) for src in PTXAS_SOURCES}})


def phase_kernels(torch, card: str) -> dict:
    """Each kernel against its plain version at the serve path's shapes."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.core.errors import ErrorCode
    from repro_torch.kernels import flash_attention, probe_rows
    from repro_torch.kernels.fault_probe import probe_rows_ref
    from repro_torch.kernels.flash_attention import sdpa_ref
    from repro_torch.kernels.flash_attention.ops import plan

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    randn = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
    out = {}

    # -- flash decode: one query row per slot at its own position, whole cache
    B, Hq, Hkv, D = NUM_SLOTS, 16, 8, 128
    pos = [0, 1, 100, 511, 700, 1022, MAX_LEN - 1, 1500]       # 1500 >= cap
    q, k, v = randn(B, 1, Hq, D), randn(B, MAX_LEN, Hkv, D), randn(B, MAX_LEN, Hkv, D)
    off = torch.tensor(pos, dtype=torch.int32, device=dev)
    got, route = flash_call(flash_attention, q, k, v, off, causal=True, seq_kv=MAX_LEN)
    want = sdpa_ref(q, k, v, q_offset=off, causal=True, seq_kv=MAX_LEN)
    err = (got.float() - want.float()).abs().max().item()
    excess = flash_excess(got, want)
    # controls: the last key dropped (slots at or past MAX_LEN - 1), and the
    # key after the first split boundary replaced by the one before it
    # (slots past the boundary)
    dropped = flash_excess(flash_attention(q, k, v, off, causal=True,
                                           seq_kv=MAX_LEN - 1), want)
    edge = plan(1, MAX_LEN, Hkv, q.dtype).keys_per_split
    doubled = flash_excess(flash_attention(*(q, *key_doubled(k, v, edge)), off,
                                           causal=True, seq_kv=MAX_LEN), want)
    if not (err <= FLASH_TOL and excess <= 1 < min(dropped, doubled)):
        fail(f"flash decode: error {err} (limit {FLASH_TOL}), {excess} x the "
             f"relative limit; one key dropped reads {dropped} x, key {edge} "
             f"replaced by key {edge - 1} reads {doubled} x (both must exceed 1)")
    kpos = torch.arange(MAX_LEN, device=dev)
    mask = (kpos[None, :] <= off[:, None])[:, None, None, :]
    heads_first = lambda *ts: tuple(t.transpose(1, 2) for t in ts)  # noqa: E731
    lib = F.scaled_dot_product_attention(*heads_first(q, k, v), attn_mask=mask,
                                         enable_gqa=True).transpose(1, 2)
    lib_err = (lib.float() - want.float()).abs().max().item()
    ctx = [min(p + 1, MAX_LEN) for p in pos]
    nbytes = 2 * B * Hq * D * 2 + 2 * sum(ctx) * Hkv * D * 2 + 4 * B
    flops = sum(4 * Hq * c * D for c in ctx)
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    qkv = copies(lambda: (randn(B, 1, Hq, D), randn(B, MAX_LEN, Hkv, D),
                          randn(B, MAX_LEN, Hkv, D)),
                 (B * Hq + 2 * B * MAX_LEN * Hkv) * D * 2)
    out["flash_decode"] = {
        "shape": f"q {B}x1x{Hq}x{D}, kv {B}x{MAX_LEN}x{Hkv}x{D} bf16, pos {pos}", **route,
        "max_abs_err": err, "tol": FLASH_TOL,
        "rel_tol": f"{FLASH_RG_TOL[0]} abs + {FLASH_RG_TOL[1]} rel",
        "err_over_tol": excess, "one_key_dropped_over_tol": dropped,
        f"key_{edge}_doubled_over_tol": doubled, "library_err": lib_err,
        "timing_copies": len(qkv),
        "kernel_ms": time_ms(torch, lambda q, k, v: flash_attention(
            q, k, v, off, causal=True, seq_kv=MAX_LEN), qkv),
        "plain_ms": time_ms(torch, lambda q, k, v: sdpa_ref(
            q, k, v, q_offset=off, causal=True, seq_kv=MAX_LEN), qkv),
        "library_ms": time_ms(torch, lambda *t: F.scaled_dot_product_attention(
            *t, attn_mask=mask, enable_gqa=True), [heads_first(*t) for t in qkv]),
        "bound_ms": b_ms, "bound_by": b_by}

    # -- flash verify: the speculative verify's T = D + 1 rows per slot over
    #    the same cache in one launch (flash_decode.cu with nq = T), rows at
    #    split and tile edges and past the capacity
    T = SPEC["draft_len"] + 1
    vpos = [0, 1, 61, 509, 700, MAX_LEN - T, MAX_LEN - 2, 1500]
    q = randn(B, T, Hq, D)
    voff = torch.tensor(vpos, dtype=torch.int32, device=dev)
    got, route = flash_call(flash_attention, q, k, v, voff, causal=True,
                            seq_kv=MAX_LEN, verify=True)
    want = sdpa_ref(q, k, v, q_offset=voff, causal=True, seq_kv=MAX_LEN)
    rows = torch.cat([flash_attention(q[:, t:t + 1].contiguous(), k, v, voff + t,
                                      causal=True, seq_kv=MAX_LEN) for t in range(T)],
                     dim=1)
    err = (got.float() - want.float()).abs().max().item()
    excess = flash_excess(got, want)
    dropped = flash_excess(flash_attention(q, k, v, voff, causal=True,
                                           seq_kv=MAX_LEN - 1, verify=True), want)
    doubled = flash_excess(flash_attention(q, *key_doubled(k, v, edge), voff,
                                           causal=True, seq_kv=MAX_LEN, verify=True),
                           want)
    bit_equal = torch.equal(got, rows)
    if not (route["kernel"] == "flash_verify" and bit_equal and err <= FLASH_TOL
            and excess <= 1 < min(dropped, doubled)):
        fail(f"flash verify: {route['kernel']}, rows bit-equal to decode: "
             f"{bit_equal}, error {err} (limit {FLASH_TOL}), {excess} x the "
             f"relative limit; one key dropped reads {dropped} x, key {edge} "
             f"replaced by key {edge - 1} reads {doubled} x (both must exceed 1)")
    qp = voff[:, None] + torch.arange(T, device=dev)                    # (B, T)
    vmask = (kpos[None, None, :] <= qp[:, :, None])[:, None]            # (B, 1, T, cap)
    vctx = [min(p + T, MAX_LEN) for p in vpos]
    nbytes = 2 * B * T * Hq * D * 2 + 2 * sum(vctx) * Hkv * D * 2 + 4 * B
    flops = sum(4 * Hq * D * min(p + t + 1, MAX_LEN) for p in vpos for t in range(T))
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    qkv = copies(lambda: (randn(B, T, Hq, D), randn(B, MAX_LEN, Hkv, D),
                          randn(B, MAX_LEN, Hkv, D)),
                 (B * T * Hq + 2 * B * MAX_LEN * Hkv) * D * 2)
    out["flash_verify"] = {
        "shape": f"q {B}x{T}x{Hq}x{D}, kv {B}x{MAX_LEN}x{Hkv}x{D} bf16, pos {vpos}",
        **route, "max_abs_err": err, "tol": FLASH_TOL,
        "rel_tol": f"{FLASH_RG_TOL[0]} abs + {FLASH_RG_TOL[1]} rel",
        "err_over_tol": excess, "one_key_dropped_over_tol": dropped,
        f"key_{edge}_doubled_over_tol": doubled,
        "rows_bit_equal_decode": bit_equal, "timing_copies": len(qkv),
        "kernel_ms": time_ms(torch, lambda q, k, v: flash_attention(
            q, k, v, voff, causal=True, seq_kv=MAX_LEN, verify=True), qkv),
        "plain_ms": time_ms(torch, lambda q, k, v: sdpa_ref(
            q, k, v, q_offset=voff, causal=True, seq_kv=MAX_LEN), qkv),
        "library_ms": time_ms(torch, lambda *t: F.scaled_dot_product_attention(
            *t, attn_mask=vmask, enable_gqa=True), [heads_first(*t) for t in qkv]),
        "bound_ms": b_ms, "bound_by": b_by}
    del qkv

    # -- flash forward: B 1, S 512, causal (Model.forward's shape)
    S = 512
    q, k, v = randn(1, S, Hq, D), randn(1, S, Hkv, D), randn(1, S, Hkv, D)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    got, route = flash_call(flash_attention, q, k, v, zero, causal=True)
    want = sdpa_ref(q, k, v, q_offset=zero, causal=True)
    err = (got.float() - want.float()).abs().max().item()
    excess = flash_excess(got, want)
    # control: the last key dropped (row S - 1 loses its diagonal key)
    dropped = flash_excess(flash_attention(q, k, v, zero, causal=True,
                                           seq_kv=S - 1), want)
    if not (err <= FLASH_TOL and excess <= 1 < dropped):
        fail(f"flash forward: error {err} (limit {FLASH_TOL}), {excess} x the "
             f"relative limit; one key dropped reads {dropped} x (must exceed 1)")
    nbytes = 2 * S * Hq * D * 2 + 2 * S * Hkv * D * 2 + 4
    flops = 4 * Hq * D * S * (S + 1) // 2
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    qkv = copies(lambda: (randn(1, S, Hq, D), randn(1, S, Hkv, D),
                          randn(1, S, Hkv, D)), S * (Hq + 2 * Hkv) * D * 2)
    out["flash_forward"] = {
        "shape": f"q 1x{S}x{Hq}x{D}, kv 1x{S}x{Hkv}x{D} bf16, causal", **route,
        "max_abs_err": err, "tol": FLASH_TOL,
        "rel_tol": f"{FLASH_RG_TOL[0]} abs + {FLASH_RG_TOL[1]} rel",
        "err_over_tol": excess, "one_key_dropped_over_tol": dropped,
        "timing_copies": len(qkv),
        "kernel_ms": time_ms(torch, lambda q, k, v: flash_attention(
            q, k, v, zero, causal=True), qkv),
        "plain_ms": time_ms(torch, lambda q, k, v: sdpa_ref(
            q, k, v, q_offset=zero, causal=True), qkv),
        "library_ms": time_ms(torch, lambda *t: F.scaled_dot_product_attention(
            *t, is_causal=True, enable_gqa=True), [heads_first(*t) for t in qkv]),
        "bound_ms": b_ms, "bound_by": b_by}

    # -- flash's fp32 route (flash_f32, the CUDA cores) at the same decode
    #    and forward shapes in fp32: held to its plain version, timed
    f32 = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev)
    off = torch.tensor(pos, dtype=torch.int32, device=dev)
    kpos = torch.arange(MAX_LEN, device=dev)
    mask = (kpos[None, :] <= off[:, None])[:, None, None, :]
    fwd_flops = 4 * Hq * D * S * (S + 1) // 2
    for name, (qs, kvs), kw, lib_kw, (nbytes, flops) in (
            ("flash_f32_decode", ((B, 1, Hq, D), (B, MAX_LEN, Hkv, D)),
             {"q_offset": off, "causal": True, "seq_kv": MAX_LEN},
             {"attn_mask": mask},
             (2 * B * Hq * D * 4 + 2 * sum(ctx) * Hkv * D * 4 + 4 * B,
              sum(4 * Hq * c * D for c in ctx))),
            ("flash_f32_forward", ((1, S, Hq, D), (1, S, Hkv, D)),
             {"q_offset": zero, "causal": True}, {"is_causal": True},
             (2 * S * Hq * D * 4 + 2 * S * Hkv * D * 4 + 4, fwd_flops))):
        q, k, v = f32(*qs), f32(*kvs), f32(*kvs)
        o = kw.pop("q_offset")
        got, route = flash_call(flash_attention, q, k, v, o, **kw)
        want = sdpa_ref(q, k, v, q_offset=o, **kw)
        err = (got - want).abs().max().item()
        excess = ((got - want).abs() / (FLASH_F32_TOL + FLASH_F32_TOL * want.abs())).max().item()
        if route["kernel"] != "flash_f32" or excess > 1:
            fail(f"{name}: {route['kernel']}, error {err}, {excess} x the limit")
        lib = F.scaled_dot_product_attention(*heads_first(q, k, v), enable_gqa=True,
                                             **lib_kw).transpose(1, 2)
        b_ms, b_by = bound(nbytes, flops, PEAK_FP32_FLOPS)
        qkv = copies(lambda: (f32(*qs), f32(*kvs), f32(*kvs)),
                     (math.prod(qs) + 2 * math.prod(kvs)) * 4)
        out[name] = {
            "shape": f"q {'x'.join(map(str, qs))}, kv {'x'.join(map(str, kvs))} fp32, "
                     + (f"pos {pos}" if "seq_kv" in kw else "causal"), **route,
            "max_abs_err": err, "tol": f"{FLASH_F32_TOL} abs + {FLASH_F32_TOL} rel",
            "err_over_tol": excess,
            "library_err": (lib - want).abs().max().item(),
            "timing_copies": len(qkv),
            "kernel_ms": time_ms(torch, lambda q, k, v: flash_attention(q, k, v, o, **kw), qkv),
            "plain_ms": time_ms(torch, lambda q, k, v: sdpa_ref(q, k, v, q_offset=o, **kw),
                                qkv),
            "library_ms": time_ms(torch, lambda *t: F.scaled_dot_product_attention(
                *t, enable_gqa=True, **lib_kw), [heads_first(*t) for t in qkv]),
            "bound_ms": b_ms, "bound_by": b_by}
        del q, k, v, got, want, lib, qkv

    # -- probe: one word per row of (slots, vocab) fp32 logits
    V = 151936
    nf, ov = int(ErrorCode.NONFINITE_LOSS), int(ErrorCode.DIVERGENCE)
    x = torch.from_numpy(rng.standard_normal((NUM_SLOTS, V)).astype(np.float32)).to(dev)
    x[1, 7] = float("nan")
    x[2, V - 1] = float("inf")
    x[3, V // 2] = float("-inf")
    x[4, 3] = 2e4                                   # over a 1e4 threshold
    words, err = {}, 0
    for thr in (1e4, math.inf):
        got = probe_rows(x, thr, nonfinite_code=nf, overflow_code=ov)
        want = probe_rows_ref(x, thr, nonfinite_code=nf, overflow_code=ov)
        err = max(err, (got - want).abs().max().item())
        if not torch.equal(got, want):
            fail(f"probe_rows disagrees with its plain version at threshold "
                 f"{thr}: {got.tolist()} vs {want.tolist()}")
        words[str(thr)] = got.tolist()
    if words["10000.0"] != [0, nf, nf, nf, ov, 0, 0, 0]:
        fail(f"probe_rows words wrong: {words}")
    b_ms, b_by = bound(NUM_SLOTS * V * 4 + NUM_SLOTS * 4, 3 * NUM_SLOTS * V,
                       PEAK_FP32_FLOPS)
    clean = copies(lambda: (torch.from_numpy(rng.standard_normal(
        (NUM_SLOTS, V)).astype(np.float32)).to(dev),), NUM_SLOTS * V * 4)
    out["probe_rows"] = {
        "shape": f"{NUM_SLOTS}x{V} fp32, threshold inf", "words": words,
        "max_abs_err": err, "timing_copies": len(clean),
        "kernel_ms": time_ms(torch, lambda x: probe_rows(
            x, math.inf, nonfinite_code=nf, overflow_code=ov), clean),
        "plain_ms": time_ms(torch, lambda x: probe_rows_ref(
            x, math.inf, nonfinite_code=nf, overflow_code=ov), clean),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}

    # -- probe over the speculative verify's logits: (slots x rows, vocab)
    rows = NUM_SLOTS * T
    x = torch.from_numpy(rng.standard_normal((rows, V)).astype(np.float32)).to(dev)
    x[5, 0] = float("nan")
    x[rows - 1, V - 1] = float("-inf")
    got = probe_rows(x, math.inf, nonfinite_code=nf, overflow_code=ov)
    want = probe_rows_ref(x, math.inf, nonfinite_code=nf, overflow_code=ov)
    hit = got.nonzero().flatten().tolist()
    if not torch.equal(got, want) or hit != [5, rows - 1]:
        fail(f"probe_rows over the verify's logits: words at {hit}, "
             f"{got.tolist()} vs {want.tolist()}")
    b_ms, b_by = bound(rows * V * 4 + rows * 4, 3 * rows * V, PEAK_FP32_FLOPS)
    clean = copies(lambda: (torch.from_numpy(rng.standard_normal(
        (rows, V)).astype(np.float32)).to(dev),), rows * V * 4)
    out["probe_verify"] = {
        "shape": f"{rows}x{V} fp32 ({NUM_SLOTS} slots x {T} verify rows), threshold inf",
        "words_at": hit, "max_abs_err": (got - want).abs().max().item(),
        "timing_copies": len(clean),
        "kernel_ms": time_ms(torch, lambda x: probe_rows(
            x, math.inf, nonfinite_code=nf, overflow_code=ov), clean),
        "plain_ms": time_ms(torch, lambda x: probe_rows_ref(
            x, math.inf, nonfinite_code=nf, overflow_code=ov), clean),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    del x, clean
    emit({"phase": "kernels", "card": card, **out})
    return out


def make_requests(cfg, Request, long: int = 0, n: int = NUM_REQUESTS,
                  short: int = 0):
    """The serve phases' traffic, its first ``n`` requests; the first
    ``long`` requests get prompts of ``LONG_PROMPT`` tokens instead, and
    ``short`` requests with ``SHORT_PROMPT``-token prompts follow them, ids
    ``n`` on (both drawn apart, so the others do not change)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 257)))
               for _ in range(NUM_REQUESTS)]
    rng_long = np.random.default_rng(SEED + 7)
    for i in range(long):
        prompts[i] = rng_long.integers(0, cfg.vocab_size, LONG_PROMPT)
    rng_short = np.random.default_rng(SEED + 10)
    prompts = prompts[:n] + [rng_short.integers(0, cfg.vocab_size, SHORT_PROMPT)
                             for _ in range(short)]
    return [Request(id=i, prompt=tuple(int(t) for t in p), max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts)]


def engine_requests(cfg, Request, n: int = ENGINE_REQUESTS):
    """The engines phases' traffic: prompts of 8-32 tokens, ENGINE_NEW new
    tokens each."""
    import numpy as np
    rng = np.random.default_rng(SEED + 6)
    return [Request(id=i, prompt=tuple(int(t) for t in rng.integers(
                        0, cfg.vocab_size, int(rng.integers(8, 33)))),
                    max_new_tokens=ENGINE_NEW)
            for i in range(n)]


def injector(horizon: int, first_cycle: int, new_tokens: int):
    """An ``inject`` for :func:`drive`: from cycle ``first_cycle`` on, a
    NaN through ``Replica.inject_state_fault`` in the first slot that is
    decoding and still needs more than ``horizon`` tokens (the steps already
    in flight). ``state`` gets the slot and the layers poisoned (as the
    replica computes them: no device read inside the timed run)."""
    state = {"cycles": 0, "slot": None, "layers": None}

    def inject(r) -> bool:
        state["cycles"] += 1
        if state["cycles"] < first_cycle:
            return False
        for s in r.sched.slots:
            if (s.active and s.pending is None and s.generated
                    and new_tokens - len(s.generated) > horizon):
                state["slot"] = r.inject_state_fault(s.idx)
                state["layers"] = r.state_fault_layers()
                return True
        return False

    return inject, state


def drive(rep, reqs, inject=None):
    """Serve ``reqs`` to completion; ``inject(rep)`` is offered every cycle
    and returns True once it has injected."""
    for r in reqs:
        if rep.submit(r) is not None:
            fail(f"request {r.id} rejected")
    out = {}
    while not rep.idle():
        if inject is not None and inject(rep):
            inject = None
        for resp in rep.step():
            out[resp.id] = resp
    return out, inject is None


def readback_sites() -> set:
    """``file:line`` of every line of ``readback``, the port's one
    device-to-host path: where sync debug mode may find a sync."""
    import inspect

    from repro_torch.core.device_channel import readback
    lines, start = inspect.getsourcelines(readback)
    path = os.path.relpath(inspect.getsourcefile(readback), ROOT)
    return {f"{path}:{start + i}" for i in range(len(lines))}


def build_model(torch, cfg):
    from repro_torch.models import Model
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def phase_serve(torch, card: str, model, init_s: float, names=("serve", "lflr"),
                long: int = 0, poison_layers=None, paged: bool = False,
                want=None, n: int = NUM_REQUESTS, spec=None, traced: bool = False,
                sync_sites: bool = False, line=None, short: int = 0):
    """The serve phases (every architecture's): serve the
    traffic clean, then again with an injected state fault (no second run
    where ``names[1]`` is None). ``long`` requests get
    ``LONG_PROMPT``-token prompts, and the longest answer is then the one
    held against the forward; ``poison_layers``, where given, is where the
    fault must land. ``paged`` serves through the page pool (``PAGED``),
    whose clean streams must equal ``want`` (the contiguous run's), and adds
    the pool's numbers and the time of one whole-tree gather + scatter to
    the line. ``spec`` (an engine's draft fields, ``SPEC``) serves through
    the speculative windows: the streams must equal ``want`` (serve's), and
    the line adds the drafted,
    accepted and rejected tokens and serve's ms per step and tokens/s from
    the same call. ``n`` cuts the traffic to its first requests, and
    ``short`` adds short-prompt requests after them (``make_requests``;
    the shortest prompt's answer is the one held against the forward).
    ``traced``
    serves the faulted traffic a second time, through a fresh replica with
    a ``Tracer``, holds it to the untraced faulted run and its trace to
    :func:`check_lflr_trace`. ``sync_sites`` counts the clean run's host
    syncs by site with torch's sync debug mode (only its "synchronizing
    CUDA operation" warnings): every one must lie in ``readback``
    (:func:`readback_sites`), and the line reports every site. ``line``
    adds its items to the clean run's line. Returns the kernel launches by
    path (the clean run's under ``names[0]``, the faulted run's — traced,
    where ``traced`` — under ``names[1]``) and the clean streams."""
    from repro_torch.core.device_channel import readback
    from repro_torch.core.errors import ErrorCode
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import EngineConfig, Replica, Request, ServeMetrics

    cfg = model.cfg
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    rep = Replica(cfg, model, config=EngineConfig(
        window=WINDOW, overlap=True, num_slots=NUM_SLOTS, max_len=MAX_LEN,
        **(PAGED if paged else {}), **(spec or {})))
    t0 = time.perf_counter()
    rep.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    # ---- the main path, counts from 0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    readback.count = 0
    with warnings.catch_warnings(record=sync_sites) as caught:
        if sync_sites:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            clean, _ = drive(rep, make_requests(cfg, Request, long, n, short))
        finally:
            if sync_sites:
                torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sites = Counter(f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught or ()
                    if "called a synchronizing CUDA operation" in str(w.message))
    stray = {k: v for k, v in sites.items() if k not in readback_sites()}
    if sync_sites and (stray or not sites):
        fail(f"{names[0]}: host syncs outside core/device_channel.py::readback: "
             f"{stray} (all sites: {dict(sites)})")
    launches = launch_counts()
    syncs = readback.count
    peak = torch.cuda.max_memory_allocated() / 1e9   # before the checks' own
    m = rep.metrics
    bad = [r.id for r in clean.values() if not r.ok or len(r.tokens) != MAX_NEW]
    if len(clean) != n + short or bad:
        fail(f"{names[0]}: {len(clean)} answers, not OK or short: {bad}")
    steps = WINDOW * m.windows
    probes = 1 + len(model.state_leaves)
    # per window step: flash once per attention layer, through the decode
    # kernel; the probe over the logits, and over the recurrent state where
    # there is one; no scan. Speculating: spec_launches
    expected = dict.fromkeys(launches, 0)
    if spec:
        expected.update(spec_launches(model, spec, steps))
    else:
        expected.update({"flash_attention": len(model.attn_layers) * steps,
                         "flash_decode": len(model.attn_layers) * steps,
                         "probe_rows": probes * steps})
    if launches != expected:
        fail(f"{names[0]}: kernel launches {launches} != {expected} "
             f"({len(model.attn_layers)} attention layers, "
             f"{probes} probes x {steps} window steps)")
    if syncs != 2 * m.windows:
        fail(f"{names[0]}: {syncs} host syncs for {m.windows} windows (2 per "
             "window expected)")
    if m.faults:
        fail(f"{names[0]}: clean run recorded faults: {m.faults}")
    if want is not None and streams(clean) != want:
        diff = [i for i in want if clean[i].tokens != want[i]]
        fail(f"{names[0]}: streams differ from the {'serve' if spec else 'contiguous'} "
             f"run for requests {diff}")
    pool = paged_report(torch, rep, names[0]) if paged else {}
    drafts = spec_report(m, spec, syncs) if spec else {}
    tokens = sum(len(r.tokens) for r in clean.values())
    reqs = make_requests(cfg, Request, long, n, short)
    if cfg.is_moe:
        # reported, not gated: routing near-ties part the bf16 decode from
        # the forward (check_moe_against_forward); phase_moe gates in fp32
        forward = {"bf16": check_moe_against_forward(torch, model, clean, reqs,
                                                     gate=False)}
    else:
        forward = check_against_forward(torch, model, clean, reqs, longest=bool(long))
    if "ssd" in cfg.block_pattern:
        # bf16 decode (one-step state update, the conv as one product) and
        # the chunked forward round differently and drift apart over depth,
        # in the JAX package too (tests/test_torch_ssd.py): the bf16 stream
        # may meet the forward on one request by chance, so the stream is
        # also held to it in fp32, where the two paths agree
        forward = {"bf16": forward, "fp32": check_fp32_stream(torch, model, reqs)}
    emit({"phase": names[0], "card": card, "model": cfg.name,
          "layers": cfg.num_layers, "pattern": list(cfg.block_pattern),
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "weight_gb": weight_bytes / 1e9,
          "init_s": init_s, "warmup_s": warmup_s, "requests": len(clean),
          "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
          "windows": m.windows, "steps": steps, "ms_per_step": wall / steps * 1e3,
          "syncs": syncs, "window_waits": m.window_waits, "launches": launches,
          "ttft_p50_s": m.ttft_percentiles()["p50"],
          "latency_p99_s": m.latency_percentiles()["p99"],
          "peak_mem_gb": peak, "forward_check": forward, **pool, **drafts,
          **({"torch_syncs": sum(sites.values()), "torch_sync_sites": dict(sites)}
             if sync_sites else {}), **(line or {})})
    SERVE_LINES[names[0]] = {"ms_per_step": wall / steps * 1e3,
                             "tokens_per_s": tokens / wall,
                             "accepted": m.accepted_draft_tokens,
                             "rejected": m.draft_tokens - m.accepted_draft_tokens}
    if names[1] is None:
        return {names[0]: launches}, streams(clean)

    # ---- same traffic, a NaN in an active slot's state mid-run, in a slot
    # decoding and busy past the in-flight and the next window (speculating,
    # past the in-flight window: it may commit K (D + 1) tokens)
    horizon = WINDOW * (spec["draft_len"] + 1) if spec else 2 * WINDOW

    def lflr_run(rep):
        inject, state = injector(horizon, 6, MAX_NEW)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        readback.count = 0
        t0 = time.perf_counter()
        answers, injected = drive(rep, make_requests(cfg, Request, long, n, short),
                                  inject)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return dict(answers=answers, injected=injected, state=state, wall=wall,
                    syncs=readback.count, launches=launch_counts(), m=rep.metrics,
                    ms_per_step=wall / (WINDOW * rep.metrics.windows) * 1e3,
                    peak=torch.cuda.max_memory_allocated() / 1e9)

    rep.metrics = ServeMetrics()
    run = lflr_run(rep)
    faulted, state, fm = run["answers"], run["state"], run["m"]
    lflr_wall, lflr_syncs = run["wall"], run["syncs"]
    if not run["injected"]:
        fail(f"{names[1]}: no decoding slot to poison")
    if poison_layers is not None and state["layers"] != poison_layers:
        fail(f"{names[1]}: the fault landed in layers {state['layers']}, not "
             f"{poison_layers}")
    if state["slot"] is None:
        fail(f"{names[1]}: the poisoned slot owned no page")
    # recurrent state: the state probe's STATE_FAULT; KV: non-finite logits
    code = ErrorCode.STATE_FAULT if model.state_leaves else ErrorCode.NONFINITE_LOSS
    latched = [f for f in fm.faults if f.code & int(code)]
    if not latched or state["slot"] not in latched[0].slots:
        fail(f"{names[1]}: the probe did not latch {code.name} on slot "
             f"{state['slot']}: {fm.faults}")
    diff = [i for i in clean if faulted.get(i) is None
            or not faulted[i].ok or faulted[i].tokens != clean[i].tokens]
    if diff:
        fail(f"{names[1]}: streams differ from the clean run for requests {diff}")
    if spec and any(f.code & int(ErrorCode.DRAFT_REJECT) for f in fm.faults):
        fail(f"{names[1]}: a fault record carries DRAFT_REJECT: {fm.faults}")
    paths = {names[0]: launches, names[1]: run["launches"]}
    trace_line = {}
    if traced:
        # the same faulted traffic again through a fresh replica with a
        # Tracer: the same streams, fault words, recovery actions, host
        # syncs and launches as the untraced run, and its trace's gates
        from repro_torch.obs import Tracer
        conf = rep.config
        del rep
        gc.collect()
        tracer = Tracer()
        rep = Replica(cfg, model, config=conf, tracer=tracer)
        rep.warmup()                     # clears the warm-up's events
        torch.cuda.synchronize()
        traced_run = lflr_run(rep)
        tm = traced_run["m"]
        got = {i: r.tokens for i, r in traced_run["answers"].items()
               if r.ok}
        if got != streams(clean) or traced_run["state"]["slot"] != state["slot"]:
            fail(f"{names[1]}: the traced run's streams or poisoned slot differ "
                 "from the untraced run's")
        decisions = [[(f.code, f.action, f.slots) for f in r.faults]
                     for r in (fm, tm)]
        if decisions[0] != decisions[1]:
            fail(f"{names[1]}: fault words or actions traced {decisions[1]}, "
                 f"untraced {decisions[0]}")
        # tracing adds no sync: 2 per window, and the fault path's one
        # readback of the window's word history (its steps, its per-slot
        # words and the trace's fault events share the copy)
        if (traced_run["syncs"] != lflr_syncs
                or traced_run["syncs"] != 2 * tm.windows + len(tm.faults)):
            fail(f"{names[1]}: {traced_run['syncs']} host syncs traced, "
                 f"{lflr_syncs} untraced, for {tm.windows} windows and "
                 f"{len(tm.faults)} faulted windows (2 per window, 1 per fault)")
        if traced_run["launches"] != run["launches"]:
            fail(f"{names[1]}: kernel launches traced {traced_run['launches']}, "
                 f"untraced {run['launches']}")
        paths[names[1]] = traced_run["launches"]
        trace_line = check_lflr_trace(names[1], tracer, tm, state["slot"],
                                      traced_run["ms_per_step"], run["ms_per_step"])
    emit({"phase": names[1], "card": card, "model": cfg.name,
          "poisoned_slot": state["slot"], "poisoned_layers": state["layers"],
          "latched": code.name,
          "faults": [{"step": f.step, "code": f.code, "action": f.action,
                      "slots": list(f.slots)} for f in fm.faults],
          "recovery_action": latched[0].action,
          "retries": sum(r.retries for r in faulted.values()),
          **({"ms_per_step": run["ms_per_step"],
              "tokens_per_s": sum(len(r.tokens) for r in faulted.values()) / lflr_wall,
              **spec_report(fm, spec, lflr_syncs)} if spec else {}),
          "syncs": lflr_syncs, "windows": fm.windows, **trace_line,
          "streams_bit_equal": True, "wall_s": lflr_wall, "peak_mem_gb": run["peak"]})
    return paths, streams(clean)


def check_lflr_trace(name: str, tracer, m, slot: int, ms_traced: float,
                     ms_untraced: float) -> dict:
    """The gates of a traced LFLR run: ``validate()`` empty; one fault
    event per attributed ``(window, slot)`` of each fault record, carrying
    the record's action and a word within the record's (together, the
    record's word), the poisoned slot's with the probe's NONFINITE_LOSS;
    every fault resolved by a recovery span that closed as recovered.
    Returns the line's trace fields: the event count, and ms per window
    step of the same faulted traffic traced and untraced, in the same call
    (reported, not gated: steps move between runs, PERF.md §5)."""
    from repro_torch.core.errors import ErrorCode
    from repro_torch.obs import fault_report, merge_traces, validate

    trace = merge_traces(tracer)
    problems = validate(trace)
    if problems:
        fail(f"{name}: the trace does not validate: {problems[:5]}")
    report = fault_report(trace)
    want = sorted((f.action, s) for f in m.faults for s in f.slots)
    got = sorted((fr.action, fr.slot) for fr in report)
    if got != want:
        fail(f"{name}: fault events {got}, fault records {want}")
    for f in m.faults:
        word = 0
        for fr in report:
            if fr.action == f.action and fr.slot in f.slots:
                word |= fr.code
        if word != f.code:
            fail(f"{name}: the fault events' words OR to {word}, the record's "
                 f"is {f.code}")
    mine = [fr for fr in report if fr.slot == slot]
    if not mine or not all(fr.code & int(ErrorCode.NONFINITE_LOSS) for fr in mine):
        fail(f"{name}: no NONFINITE_LOSS fault event on the poisoned slot {slot}")
    unclosed = [(fr.window, fr.step, fr.slot) for fr in report
                if fr.recovery is None
                or fr.recovery["args"].get("outcome") != "recovered"]
    if unclosed:
        fail(f"{name}: faults without a closed recovery span: {unclosed}")
    return {"trace_events": tracer.num_events,
            "trace_faults": [{"window": fr.window, "step": fr.step,
                              "slot": fr.slot, "code": fr.code,
                              "action": fr.action, "recovery_ms": fr.recovery_s * 1e3}
                             for fr in report],
            "ms_per_step_traced": ms_traced,
            "ms_per_step_untraced": ms_untraced,
            "traced_over_untraced": ms_traced / ms_untraced}


def spec_launches(model, spec: dict, steps: int) -> dict:
    """A speculative run's kernel launches over ``steps`` window steps: the
    draft's decode kernel once per draft step and drafting layer, the
    verify route once per layer, one probe over the verify's logits."""
    drafts = spec["draft_len"] * spec["draft_layers"] * steps
    verify = len(model.attn_layers) * steps
    return {"flash_attention": drafts + verify, "flash_decode": drafts,
            "flash_verify": verify, "probe_rows": steps}


def spec_report(m, spec: dict, syncs: int) -> dict:
    """A speculative serve run's drafts: drafted, accepted and rejected
    tokens, the acceptance rate, the tokens a window step commits, host
    syncs per window, and serve's ms per window step and tokens/s from the
    same call beside them."""
    return {"draft_len": spec["draft_len"], "draft_layers": spec["draft_layers"],
            "drafted": m.draft_tokens, "accepted": m.accepted_draft_tokens,
            "rejected": m.draft_tokens - m.accepted_draft_tokens,
            "acceptance_rate": m.acceptance_rate(),
            "tokens_per_step": m.tokens_per_step(),
            "syncs_per_window": syncs / m.windows,
            "serve_ms_per_step": SERVE_LINES["serve"]["ms_per_step"],
            "serve_tokens_per_s": SERVE_LINES["serve"]["tokens_per_s"],
            "streams_equal_serve": True}


def paged_report(torch, rep, name: str) -> dict:
    """The page pool after a clean paged run: every page back
    (``pages_allocated == pages_freed``, the ledger consistent), the
    pool's size, and the device time of one whole-tree gather + scatter
    with every slot's pages mapped, beside its bytes bound (the pages read,
    the view written, read back and written through the table)."""
    import numpy as np
    m, layout = rep.metrics, rep.layout
    if not m.pages_allocated or m.pages_allocated != m.pages_freed:
        fail(f"{name}: pages allocated {m.pages_allocated}, freed {m.pages_freed}")
    try:
        rep.alloc.check()
    except AssertionError as exc:
        fail(f"{name}: page ledger: {exc}")
    ids = np.arange(NUM_SLOTS * layout.max_pages) % layout.num_pages
    table = torch.from_numpy(ids.reshape(NUM_SLOTS, layout.max_pages).astype(
        np.int32)).to(rep.device)

    def gather_scatter(hybrid, table):
        layout.scatter(hybrid, layout.gather(hybrid, table), table)

    ms = time_ms(torch, gather_scatter, [(rep.caches, table)], launches=16)
    nbytes = 4 * NUM_SLOTS * layout.max_pages * layout.page_bytes()
    return {"page_size": layout.page_size, "num_pages": layout.num_pages,
            "paged_leaves": sorted(n for n in rep.caches if layout.is_paged_path(n)),
            "pool_gb": layout.pool_bytes() / 1e9,
            "pages_allocated": m.pages_allocated, "pages_freed": m.pages_freed,
            "peak_pages_in_use": m.peak_pages_in_use,
            "gather_scatter_ms": ms,
            "gather_scatter_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "gather_scatter_bound_by": "bytes",
            "streams_equal_contiguous": True}


def phase_page_fault(torch, card: str, model, want: dict,
                     n: int = NUM_SLOTS) -> None:
    """The serve_paged run, on its first ``n`` requests, with one lane's
    page-table row unmapped behind the allocator's back, mid-run: the page
    probe latches PAGE_FAULT at the wait, attributed to that slot, one
    ``page_reclaim`` record follows, the LFLR re-queue rebuilds the mapping,
    and every stream equals serve's (``want``; paged ≡ contiguous)."""
    from repro_torch.core.errors import ErrorCode
    from repro_torch.serve import EngineConfig, Replica, Request

    rep = Replica(model.cfg, model, config=EngineConfig(
        window=WINDOW, overlap=True, num_slots=NUM_SLOTS, max_len=MAX_LEN, **PAGED))
    state = {"cycles": 0, "slot": None}

    def corrupt(r) -> bool:
        state["cycles"] += 1
        if state["cycles"] < 6:
            return False
        for s in r.sched.slots:
            if (s.active and s.pending is None and s.generated
                    and MAX_NEW - len(s.generated) > 2 * WINDOW
                    and r.corrupt_page_table(s.idx)):
                state["slot"] = s.idx
                return True
        return False

    t0 = time.perf_counter()
    out, injected = drive(rep, make_requests(model.cfg, Request, n=n), corrupt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = rep.metrics
    if not injected:
        fail("page_fault: no decoding slot to corrupt")
    page = [f for f in m.faults if f.code & int(ErrorCode.PAGE_FAULT)]
    reclaims = [f for f in m.faults if f.action == "page_reclaim"]
    if not page or page[0].slots != (state["slot"],):
        fail(f"page_fault: PAGE_FAULT not raised on slot {state['slot']}: {m.faults}")
    if len(reclaims) != 1 or reclaims[0].slots != (state["slot"],):
        fail(f"page_fault: page_reclaim records {reclaims}")
    bad = [i for i in range(n) if out.get(i) is None or not out[i].ok
           or out[i].tokens != want[i]]
    if bad:
        fail(f"page_fault: streams differ from serve_paged for requests {bad}")
    try:
        rep.alloc.check()
    except AssertionError as exc:
        fail(f"page_fault: page ledger: {exc}")
    emit({"phase": "page_fault", "card": card, "model": model.cfg.name,
          "requests": n, "corrupted_slot": state["slot"],
          "faults": [{"step": f.step, "code": f.code, "action": f.action,
                      "slots": list(f.slots)} for f in m.faults],
          "retries": sum(r.retries for r in out.values()),
          "streams_bit_equal": True, "wall_s": wall})


def phase_paged_pressure(torch, card: str, model, want: dict,
                         n: int = NUM_SLOTS) -> None:
    """serve's first ``n`` requests through a pool of ``PRESSURE_BUDGET``
    pages, an eighth of what 8 slots of 1024 would take: growth must
    preempt the oldest lanes back into the queue, the pool's peak stays
    within it, every request is answered OK, and the streams equal serve's
    (``want``)."""
    from repro_torch.serve import EngineConfig, Replica, Request

    rep = Replica(model.cfg, model, config=EngineConfig(
        window=WINDOW, overlap=True, num_slots=NUM_SLOTS, max_len=MAX_LEN,
        **PAGED, page_budget=PRESSURE_BUDGET))
    t0 = time.perf_counter()
    out, _ = drive(rep, make_requests(model.cfg, Request, n=n))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = rep.metrics
    if m.page_evictions < 1:
        fail("paged_pressure: the pool never ran dry (no eviction)")
    if m.peak_pages_in_use > PRESSURE_BUDGET:
        fail(f"paged_pressure: {m.peak_pages_in_use} pages in use > {PRESSURE_BUDGET}")
    bad = [i for i in range(n) if out.get(i) is None or not out[i].ok
           or out[i].tokens != want[i]]
    if bad:
        fail(f"paged_pressure: streams differ from serve for requests {bad}")
    try:
        rep.alloc.check()
    except AssertionError as exc:
        fail(f"paged_pressure: page ledger: {exc}")
    emit({"phase": "paged_pressure", "card": card, "model": model.cfg.name,
          "requests": n, "page_budget": PRESSURE_BUDGET,
          "page_evictions": m.page_evictions,
          "peak_pages_in_use": m.peak_pages_in_use,
          "peak_active_slots": m.peak_active_slots,
          "pages_allocated": m.pages_allocated, "windows": m.windows,
          "tokens_per_s": sum(len(r.tokens) for r in out.values()) / wall,
          "streams_equal_serve": True, "wall_s": wall})


def serve_engine(torch, model, conf: dict, reqs, inject=None):
    """One engine of ``conf`` serving ``reqs`` (warmed up first): the
    answers, the metrics, and the run's wall time, host syncs and kernel
    launches, the counts set to 0 just before it."""
    from repro_torch.core.device_channel import readback
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import EngineConfig, Replica

    rep = Replica(model.cfg, model, config=EngineConfig(
        num_slots=NUM_SLOTS, max_len=MAX_LEN, **conf))
    rep.warmup()
    torch.cuda.synchronize()
    reset_launch_counts()
    readback.count = 0
    t0 = time.perf_counter()
    out, injected = drive(rep, reqs, inject)
    torch.cuda.synchronize()
    return {"answers": out, "metrics": rep.metrics, "injected": injected,
            "overlap": rep.overlap,
            "wall": time.perf_counter() - t0, "syncs": readback.count,
            "launches": launch_counts()}


def streams(answers: dict) -> dict:
    return {i: r.tokens for i, r in answers.items()}


def phase_engines(torch, card: str, model) -> dict:
    """The stepwise engine, the blocking window engine and the overlapped
    one on one traffic (qwen3 at full width): every answer OK, the three
    streams equal token for token, host syncs and kernel launches as each
    engine's design says. Returns each engine's launches."""
    from repro_torch.serve import Request

    cfg = model.cfg
    reqs = engine_requests(cfg, Request)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    runs, rows, launches = {}, {}, {}
    for name, conf in ENGINES.items():
        run = serve_engine(torch, model, conf, engine_requests(cfg, Request))
        out, m = run["answers"], run["metrics"]
        bad = [r.id for r in out.values() if not r.ok or len(r.tokens) != ENGINE_NEW]
        if len(out) != ENGINE_REQUESTS or bad:
            fail(f"engines/{name}: {len(out)} answers, not OK or short: {bad}")
        if m.faults:
            fail(f"engines/{name}: clean run recorded faults: {m.faults}")
        window = conf["window"]
        steps = m.decode_steps                    # window steps, or steps
        units = m.windows if window else steps    # syncs: 2 per unit
        blocking = not run["overlap"]
        prefills = m.prefills
        if blocking and prefills != ENGINE_REQUESTS:
            fail(f"engines/{name}: {prefills} blocking prefills, not one per request")
        if run["syncs"] > 2 * units + 2 * prefills:
            fail(f"engines/{name}: {run['syncs']} host syncs for {units} "
                 f"{'windows' if window else 'steps'} and {prefills} prefills "
                 "(at most 2 each)")
        # one slot step per decode step and per prefilled token: flash once
        # per attention layer through the decode kernel, one probe
        slot_steps = steps + (prompt_tokens if blocking else 0)
        expected = dict.fromkeys(run["launches"], 0)
        expected.update({"flash_attention": len(model.attn_layers) * slot_steps,
                         "flash_decode": len(model.attn_layers) * slot_steps,
                         "probe_rows": slot_steps})
        if run["launches"] != expected:
            fail(f"engines/{name}: kernel launches {run['launches']} != {expected}")
        tokens = sum(len(r.tokens) for r in out.values())
        runs[name], launches[name] = streams(out), run["launches"]
        rows[name] = {
            "config": conf, "wall_s": run["wall"], "tokens": tokens,
            "tokens_per_s": tokens / run["wall"], "steps": steps,
            "ms_per_step": (run["wall"] - m.host_stall_s) / steps * 1e3,
            "windows": m.windows, "syncs": run["syncs"], "prefills": prefills,
            "prefill_ms_per_call": (m.host_stall_s / m.host_stalls * 1e3
                                    if m.host_stalls else None),
            "host_stall_s": m.host_stall_s, "launches": run["launches"]}
    diff = [i for i in runs["stepwise"]
            if not runs["stepwise"][i] == runs["blocking"][i] == runs["overlap"][i]]
    if diff:
        fail(f"engines: the streams of the three engines differ for requests {diff}")
    emit({"phase": "engines", "card": card, "model": cfg.name,
          "requests": ENGINE_REQUESTS, "new_tokens": ENGINE_NEW,
          "prompt_tokens": prompt_tokens, "streams_equal": True,
          "ms_per_step_note": "wall less the blocking prefills' stall, over "
                              "the decode steps", **rows})
    return {"streams": runs, "launches": launches}


def phase_spec(torch, card: str, model, init_s: float, want: dict) -> dict:
    """The speculative phases on qwen3: serve's traffic through
    ``Replica(window=8, overlap=True, speculate=True, draft_len=3,
    draft_layers=1)``, clean (streams equal serve's, ``want``) and with
    serve's injected fault (streams bit-equal to the clean run), then over
    the default page pool (every page back at drain), then
    :func:`phase_spec_deep`. One phase at least must show drafts both
    accepted and rejected. Returns each clean run's launches by path."""
    # the first 6 requests only (cut from 16 to 10 when the traced and fuzz
    # phases came, and to 6 when the LayerNorm architectures' phases came,
    # for the run's time: the first 6 drop the 225- and 254-token prompts,
    # 208 steps against 318; serve keeps the refilled slots)
    paths, _ = phase_serve(
        torch, card, model, init_s, ("serve_spec", "lflr_spec"), spec=SPEC,
        n=MOE_REQUESTS, want={i: want[i] for i in range(MOE_REQUESTS)})
    # the first 6 requests only (cut to 8 when the group phases came and to
    # 6 with the LayerNorm architectures' phases, to keep the run's time)
    paths.update(phase_serve(
        torch, card, model, init_s, ("serve_spec_paged", None), paged=True,
        spec=SPEC, n=MOE_REQUESTS, want={i: want[i] for i in range(MOE_REQUESTS)})[0])
    paths["serve_spec_deep"] = phase_spec_deep(torch, card, model)
    lines = {p: SERVE_LINES[p] for p in paths if p in SERVE_LINES}   # clean runs
    if not any(line["accepted"] and line["rejected"] for line in lines.values()):
        fail(f"speculative phases: no phase both accepted and rejected a draft: "
             f"{lines}")
    return paths


def group_run(torch, card: str, model, name: str, serve, want: dict, *,
              killed=(), answered=None, exact: bool = False) -> tuple:
    """One group phase: ``serve()`` (a ``ServeGroup`` entry point) with the
    kernel counts and host syncs from 0, then the gates every group phase
    shares: no rank raised, only the ``killed`` ranks died, every request of
    ``want`` (serve's streams) answered OK with serve's stream (``answered``
    adds responses from an earlier run). ``exact`` also holds the launches
    and syncs to the clean rule: per window step, flash decode once per
    layer and one probe; 2 syncs per retired window, summed over the ranks.
    Returns the result, its launches and the line's common fields."""
    from repro_torch.core.device_channel import readback
    from repro_torch.kernels import launch_counts, reset_launch_counts

    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    reset_launch_counts()
    readback.count = 0
    t0 = time.perf_counter()
    res = serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, syncs = launch_counts(), readback.count
    bad = [(rr.rank, repr(rr.exception)) for rr in res.reports
           if rr.exception is not None]
    if bad:
        fail(f"{name}: ranks raised: {bad}")
    died = sorted(rr.rank for rr in res.reports if rr.killed)
    if died != sorted(killed):
        fail(f"{name}: ranks {died} died, {sorted(killed)} scheduled")
    reports = [rr.value for rr in res.reports
               if not rr.killed and rr.value is not None]
    if res.crashed:
        reports = []
    responses = {**(answered or {}), **res.responses}
    if not res.crashed:
        diff = [i for i in want if i not in responses or not responses[i].ok
                or responses[i].tokens != want[i]]
        if diff or len(responses) != len(want):
            fail(f"{name}: requests {diff} not OK or not serve's stream "
                 f"({len(responses)} answers for {len(want)})")
    windows = sum(r.metrics.windows for r in reports)
    if exact:
        # per window step flash decode once per layer and one probe, over
        # every dispatched window: the retired ones, and at most one per
        # rank still in flight when the group closed (its requests were
        # answered by the window before; nothing waits on it)
        layers = len(model.attn_layers)
        steps = launches["probe_rows"]
        expected = dict.fromkeys(launches, 0)
        expected.update({"flash_attention": layers * steps,
                         "flash_decode": layers * steps, "probe_rows": steps})
        dispatched, part = divmod(steps, WINDOW)
        if (launches != expected or part
                or not 0 <= dispatched - windows <= len(reports)):
            fail(f"{name}: kernel launches {launches} for {windows} retired "
                 f"windows of {WINDOW} steps and {layers} layers")
        if syncs != 2 * windows:
            fail(f"{name}: {syncs} host syncs for {windows} retired windows")
    elif not res.crashed and not (launches["flash_decode"] > 0
                                  and launches["probe_rows"] > 0):
        fail(f"{name}: the fleet did not go through the kernels: {launches}")
    round_ms = sorted(1e3 * t for r in reports for t in r.round_s)
    tokens = sum(len(r.tokens) for r in res.responses.values())
    gc.collect()
    line = {"phase": name, "card": card, "ranks": len(res.reports),
            "requests": len(res.responses),
            "rounds": max((r.rounds for r in reports), default=0),
            "ms_per_round_median": (round_ms[len(round_ms) // 2]
                                    if round_ms else None),
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "requests_per_rank": {str(k): v for k, v in sorted(Counter(
                r.replica for r in res.responses.values()).items())},
            "windows": windows, "syncs": syncs, "launches": launches,
            "mem_before_gb": mem0 / 1e9,
            "mem_after_gb": torch.cuda.memory_allocated() / 1e9}
    return res, launches, line


def phase_group(torch, card: str, model, want: dict) -> dict:
    """The group phases (qwen3 at full width, module docstring 11c):
    ``want`` is serve's streams. ``group_kill`` and ``group_replay`` run
    with ``trace=True`` (:func:`check_group_traces`). Returns each phase's
    launches by path."""
    from repro_torch.core.faults import FaultSchedule, FaultSpec
    from repro_torch.serve import EngineConfig, Request, ServeGroup

    cfg = model.cfg
    conf = EngineConfig(window=WINDOW, num_slots=NUM_SLOTS, max_len=MAX_LEN)
    traced = EngineConfig(window=WINDOW, num_slots=NUM_SLOTS, max_len=MAX_LEN,
                          trace=True)
    group = ServeGroup(cfg, GROUP_RANKS, model=model, config=conf)
    tgroup = ServeGroup(cfg, GROUP_RANKS, model=model, config=traced)
    reqs = lambda: make_requests(cfg, Request, n=GROUP_REQUESTS)  # noqa: E731
    want = {i: want[i] for i in range(GROUP_REQUESTS)}
    paths = {}

    res, paths["group"], line = group_run(
        torch, card, model, "group", lambda: group.serve(reqs()), want, exact=True)
    if len(line["requests_per_rank"]) != GROUP_RANKS:
        fail(f"group: not every rank answered: {line['requests_per_rank']}")
    emit(line)
    clean_wall = line["wall_s"]
    SERVE_LINES["group"] = {"tokens_per_s": line["tokens_per_s"]}

    kill = FaultSchedule([FaultSpec(step=GROUP_FAULT_ROUND, kind="kill", rank=1)])
    res, paths["group_kill"], line = group_run(
        torch, card, model, "group_kill", lambda: tgroup.serve(reqs(), faults=kill),
        want, killed=(1,))
    for rank in (0, 2):
        shrinks = [e for e in res.report(rank).events if e[0] == "shrink"]
        if shrinks != [("shrink", GROUP_FAULT_ROUND, 2)]:
            fail(f"group_kill: rank {rank} shrank {shrinks}, not once to 2 "
                 f"ranks at round {GROUP_FAULT_ROUND}")
    if not res.rerouted or set(line["requests_per_rank"]) - {"0", "2"}:
        fail(f"group_kill: re-routed {res.rerouted}, answered by "
             f"{line['requests_per_rank']}")
    kill_trace = check_group_traces("group_kill", res.trace(), res.rerouted)
    emit({**line, "group_wall_s": clean_wall,
          "shrink_round": GROUP_FAULT_ROUND, "rerouted": list(res.rerouted),
          **kill_trace})

    soft = FaultSchedule([FaultSpec(step=GROUP_FAULT_ROUND, kind="state_nan",
                                    rank=0)])
    res, paths["group_soft"], line = group_run(
        torch, card, model, "group_soft", lambda: group.serve(reqs(), faults=soft),
        want)
    events = {r: res.report(r).events for r in range(GROUP_RANKS)}
    faults = {r: res.report(r).metrics.faults for r in range(GROUP_RANKS)}
    if (res.rerouted or any(e[0] in ("shrink", "reroute")
                            for ev in events.values() for e in ev)
            or len(faults[0]) != 1 or faults[1] or faults[2]
            or [e[0] for e in events[0]] != ["inject"]):
        fail(f"group_soft: the fault did not stay on rank 0: events {events}, "
             f"faults {faults}, rerouted {res.rerouted}")
    f = faults[0][0]
    emit({**line, "group_wall_s": clean_wall, "injected": events[0][0],
          "fault": {"step": f.step, "code": f.code, "action": f.action,
                    "slots": list(f.slots)}})

    wal = os.path.join(ROOT, "build", "group_replay.wal")
    if os.path.exists(wal):
        os.remove(wal)
    res1, crash_launches, line1 = group_run(
        torch, card, model, "group_replay", lambda: tgroup.serve(
            reqs(), ledger_path=wal, crash_at=GROUP_CRASH_AT), want,
        killed=range(GROUP_RANKS))
    if not res1.crashed or not res1.responses or len(res1.responses) == len(want):
        fail(f"group_replay: crashed {res1.crashed} with "
             f"{sorted(res1.responses)} answered: some, not all, expected")
    spare = ServeGroup(cfg, GROUP_RANKS, model=model, config=traced,
                       max_ranks=GROUP_RANKS + 1)
    res2, paths["group_replay"], line = group_run(
        torch, card, model, "group_replay", lambda: spare.serve_from_ledger(
            wal, joins=[1]), want, answered=res1.responses)
    back = [i for i, r in res1.responses.items() if res2.responses.get(i) != r]
    if back or res2.joined != (GROUP_RANKS,) or not res2.replayed:
        fail(f"group_replay: answered {back} came back changed, joined "
             f"{res2.joined}, replayed {res2.replayed}")
    for k, v in crash_launches.items():
        paths["group_replay"][k] += v
    from repro_torch.obs import merge_trace_dicts
    replay_trace = check_group_traces(
        "group_replay", merge_trace_dicts(res1.trace(), res2.trace()), (),
        crashed=res1.trace())
    emit({**line, **replay_trace,
          "crash_at": GROUP_CRASH_AT, "crash_wall_s": line1["wall_s"],
          "answered_before_crash": sorted(res1.responses),
          "replayed": list(res2.replayed), "joined": list(res2.joined),
          "epoch": res2.epoch, "launches": paths["group_replay"]})
    os.remove(wal)
    return paths


def check_group_traces(name: str, trace: dict, rerouted, crashed=None) -> dict:
    """The trace gates of a traced group phase: ``validate()`` empty over the
    (merged) trace. After a kill: one chain, rank 1's ``replica_kill`` then
    a ``ulfm_shrink`` on each survivor and a ``reroute`` from rank 1 for
    each re-routed request, each answered OK on the rank it went to, and
    the dead rank's own events in the merged trace. After a crash and the
    restart (``crashed``: the first incarnation's trace): each rank's
    ``fleet_stop``, and the restart's ``ledger_replay`` instant and
    ``replica_join`` and completed ``state_transfer`` spans. Returns the
    line's trace fields."""
    from repro_torch.obs import group_chains, validate
    from repro_torch.serve import OK

    evs = trace["traceEvents"]
    problems = validate(trace)
    if problems:
        fail(f"{name}: the trace does not validate: {problems[:5]}")
    names = Counter(e["name"] for e in evs if e["cat"] == "group")
    out = {"trace_events": len(evs), "group_events": dict(sorted(names.items()))}
    if crashed is None:
        chains = group_chains(trace)
        if len(chains) != 1 or chains[0]["dead_rank"] != 1:
            fail(f"{name}: chains {[c['dead_rank'] for c in chains]}, not one of rank 1")
        (chain,) = chains
        shrunk = sorted(e["pid"] for e in chain["shrinks"])
        moved = sorted(e["args"]["request"] for e in chain["reroutes"])
        answered = {tid: (t["pid"], t["args"]["status"])
                    for tid, t in chain["terminals"].items() if t is not None}
        to = {e["args"]["request"]: e["args"]["to_rank"] for e in chain["reroutes"]}
        if (shrunk != [0, 2] or moved != sorted(rerouted)
                or any(answered.get(i) != (to[i], OK) for i in moved)):
            fail(f"{name}: chain shrinks on {shrunk}, re-routes {moved} (want "
                 f"{sorted(rerouted)}), answered {answered}")
        dead = [e["name"] for e in evs if e["pid"] == 1]
        if "replica_kill" not in dead or len(dead) < 2:
            fail(f"{name}: the dead rank's events are not in the trace: {dead[:5]}")
        out.update(chain=["replica_kill", "ulfm_shrink", "reroute"],
                   chain_requests=moved, dead_rank_events=len(dead))
    else:
        stops = sorted(e["pid"] for e in crashed["traceEvents"]
                       if e["name"] == "fleet_stop")
        done = [e for e in evs if e["name"] == "state_transfer"
                and e["args"].get("complete")]
        if (stops != list(range(GROUP_RANKS)) or names["ledger_replay"] != 1
                or names["replica_join"] != 1 or len(done) != 1):
            fail(f"{name}: fleet stops on {stops}, group events {dict(names)}")
    return out


def phase_fuzz(torch, card: str, model) -> dict:
    """The fuzz kits at full width (module docstring 11d): each of
    ``FUZZ_ENTRIES`` (the reference corpus's JSON, read from the checkout)
    replays through ``repro_torch.fuzz.run_trajectory`` with the kits built
    over ``model`` on the card. Gates: zero violations (complete, bit-exact
    against the kit's clean run, the page ledger, ``validate()``, no wedge
    or crash); every response OK or FAILED; the kit's clean run bit-equal
    to itself on a second call; the path through the kernels. The counts
    go to 0 before each entry (its clean run, cached per load, included).
    Returns each engine's launches by path (``fuzz_<engine>``)."""
    from repro_torch.fuzz import load_entry, run_trajectory, runner, use_model
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import FAILED, OK

    use_model(model)
    paths, rows = {}, {}
    try:
        for entry_name in FUZZ_ENTRIES:
            traj = load_entry(os.path.join(ROOT, "tests", "fuzz_corpus",
                                           entry_name + ".json"))["trajectory"]
            reset_launch_counts()
            t0 = time.perf_counter()
            res = run_trajectory(traj)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            statuses = Counter(r.status for r in res.responses.values())
            if res.violations or set(statuses) - {OK, FAILED}:
                fail(f"fuzz/{entry_name}: violations {res.violations[:5]}, "
                     f"statuses {dict(statuses)}")
            if not (launches["flash_decode"] and launches["probe_rows"]):
                fail(f"fuzz/{entry_name}: not through the kernels: {launches}")
            # the kit's clean run once more: the cache dropped, run anew
            clean = runner.reference_tokens(traj.engine, *traj.load_key)
            runner.reference_tokens.cache_clear()
            if runner.reference_tokens(traj.engine, *traj.load_key) != clean:
                fail(f"fuzz/{entry_name}: the {traj.engine} kit's clean run "
                     "differs on a second call")
            paths[f"fuzz_{traj.engine}"] = launches
            rows[entry_name] = {
                "engine": traj.engine, "ops": len(traj.ops), "wall_s": wall,
                "statuses": dict(statuses), "cells": sorted("|".join(c) for c in res.cells),
                "trace_events": res.summary.get("trace_events"),
                "faults": res.summary.get("faults"), "launches": launches}
    finally:
        use_model(None)
    emit({"phase": "fuzz", "card": card, "model": model.cfg.name,
          "entries": rows, "violations": 0,
          "cells": sorted({c for r in rows.values() for c in r["cells"]}),
          "wall_s": sum(r["wall_s"] for r in rows.values())})
    return paths


class SmiPeak:
    """The card's peak memory in use by ``nvidia-smi`` (every process's,
    the worker processes' included), sampled every 0.25 s while open."""

    def __init__(self):
        import threading
        self.peak_mib = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits",
                 "-i", "0"], capture_output=True, text=True, timeout=30)
            if out.returncode == 0 and out.stdout.strip():
                self.peak_mib = max(self.peak_mib, int(out.stdout.split()[0]))
            self._stop.wait(0.25)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=35)


def multihost_run(torch, card: str, cfg, name: str, reqs, want: dict,
                  faults=None) -> tuple:
    """One multi-host phase: ``MULTIHOST_RANKS`` worker processes, each
    serving full-width qwen3 on the card with serve's engine and serve's
    seed, under the heartbeat supervisor, on ``reqs``. The gates every such
    phase shares: every request answered OK with its stream (``want``),
    ``validate()``
    empty over the merged trace, and every worker that said ``bye`` went
    through the kernels: ``flash_decode`` a positive multiple of the layers
    and ``probe_rows`` > 0. Returns the result, the launches summed over
    the workers that sent a ``bye`` (a killed worker's are lost with it),
    and the line's common fields."""
    from repro_torch.obs import validate
    from repro_torch.serve import EngineConfig, MultiHostSupervisor

    sup = MultiHostSupervisor(
        MULTIHOST_RANKS, backend="replica", arch=cfg.name, width="full",
        device="cuda", seed=SEED, suspect_timeout=MULTIHOST_SUSPECT_TIMEOUT,
        trace=True, timeout=MULTIHOST_TIMEOUT,
        config=EngineConfig(window=WINDOW, overlap=True, num_slots=NUM_SLOTS,
                            max_len=MAX_LEN))
    with SmiPeak() as smi:
        t0 = time.perf_counter()
        res = sup.serve(reqs, faults=faults)
        wall = time.perf_counter() - t0
    diff = [i for i in want if i not in res.responses or not res.responses[i].ok
            or res.responses[i].tokens != want[i]]
    if diff or len(res.responses) != len(want):
        fail(f"{name}: requests {diff} not OK or not serve's stream "
             f"({len(res.responses)} answers for {len(want)})")
    problems = validate(res.trace())
    if problems:
        fail(f"{name}: the merged trace does not validate: {problems[:5]}")
    layers = cfg.num_layers
    for rank, n in res.launches.items():
        if not (n["flash_decode"] > 0 and n["flash_decode"] % layers == 0
                and n["probe_rows"] > 0):
            fail(f"{name}: worker {rank} did not go through the kernels: {n}")
    launches = {k: sum(n[k] for n in res.launches.values())
                for k in next(iter(res.launches.values()))}
    tokens = sum(len(r.tokens) for r in res.responses.values())
    # serving: from the last worker's hello (the lease start) to the end
    serving = wall - max(res.ready_s.values())
    line = {"phase": name, "card": card, "model": cfg.name,
            "workers": MULTIHOST_RANKS, "requests": len(res.responses),
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "serving_s": serving, "serving_tokens_per_s": tokens / serving,
            "spawn_to_hello_s": {str(r): v for r, v in sorted(res.ready_s.items())},
            "suspected": list(res.suspected), "resumed": list(res.resumed),
            "evicted": list(res.evicted), "rerouted": list(res.rerouted),
            "epoch": res.epoch,
            "requests_per_rank": {str(k): v for k, v in sorted(Counter(
                r.replica for r in res.responses.values()).items())},
            "bye_words": {str(r): w for r, w in sorted(res.words.items())},
            "launches_by_worker": {str(r): n for r, n in sorted(res.launches.items())},
            "trace_events": len(res.events), "card_peak_mib": smi.peak_mib}
    return res, launches, line


def after_kill(events: list, retires, det: dict, dead: int) -> tuple:
    """What the survivors computed between a kill and its eviction, from
    their workers' trace (one ``time.monotonic`` clock across the host's
    processes): per survivor, the decode windows that start after
    ``kill_ts`` and end before ``evict_ts``; and the survivor retirements
    that reach the supervisor before ``evict_ts`` and whose last committing
    window (a ``decode`` span of the request with ``committed`` > 0)
    started after ``kill_ts``, as ``(retire ts, that start, rank, id)``. A
    retirement sent just after the kill from a window that ran before it
    is not counted."""
    kill, evict = det["kill_ts"] * 1e6, det["evict_ts"] * 1e6
    windows: dict = {}
    last: dict = {}
    for e in events:
        rank, args = e.get("pid"), e.get("args") or {}
        if rank == dead or e.get("ph") != "X":
            continue
        if e.get("name") == "window" and kill < e["ts"] and e["ts"] + e["dur"] < evict:
            windows[rank] = windows.get(rank, 0) + 1
        if e.get("name") == "decode" and args.get("committed", 0) > 0:
            key = (rank, args.get("trace_id"))
            last[key] = max(last.get(key, e["ts"]), e["ts"])
    in_window = [(ts, last[(r, i)] / 1e6, r, i) for ts, r, i in retires
                 if r != dead and ts * 1e6 < evict and last.get((r, i), kill) > kill]
    return windows, in_window


def phase_multihost(torch, card: str, cfg, want: dict) -> dict:
    """The multi-host phases (qwen3 at full width, module docstring 11e):
    ``want`` is serve's streams. ``multihost`` clean: nothing suspected out
    of the lease, nothing evicted or re-routed, every ``bye`` word 0, every
    worker through the kernels; fleet tokens/s beside ``group``'s.
    ``multihost_kill``, on the same requests with the staggered budgets
    of ``MULTIHOST_KILL_NEW`` and serve's streams cut to them: worker 1
    SIGKILL'd after ``MULTIHOST_KILL_AT`` retirements fleet-wide, evicted within 2 x the suspect timeout, its
    requests re-routed, the survivors' work after the kill (``after_kill``),
    their words carrying RANK_FAILED, and the trace's chain. Returns each
    phase's launches by path."""
    from repro_torch.core.errors import ErrorCode
    from repro_torch.core.faults import FaultSchedule, FaultSpec
    from repro_torch.serve import Request

    reqs = make_requests(cfg, Request, n=REFILL_REQUESTS)
    want = {i: want[i] for i in range(REFILL_REQUESTS)}
    paths = {}
    res, paths["multihost"], line = multihost_run(torch, card, cfg, "multihost",
                                                  reqs, want)
    if res.evicted or res.rerouted or res.epoch:
        fail(f"multihost: evicted {res.evicted}, re-routed {res.rerouted}, "
             f"epoch {res.epoch} in a clean run")
    if res.words != dict.fromkeys(range(MULTIHOST_RANKS), 0):
        fail(f"multihost: bye words {res.words}, all 0 expected")
    group = SERVE_LINES.get("group", {})
    emit({**line, "group_tokens_per_s": group.get("tokens_per_s"),
          "group_requests": GROUP_REQUESTS})

    kill = FaultSchedule([FaultSpec(step=MULTIHOST_KILL_AT, kind="host_kill",
                                    rank=MULTIHOST_KILLED)])
    first, step = MULTIHOST_KILL_NEW
    for r in reqs:
        r.max_new_tokens = first + step * r.id
    want = {r.id: want[r.id][:r.max_new_tokens] for r in reqs}
    res, paths["multihost_kill"], line = multihost_run(
        torch, card, cfg, "multihost_kill", reqs, want, faults=kill)
    dead, bound = MULTIHOST_KILLED, 2 * MULTIHOST_SUSPECT_TIMEOUT
    det = res.detection.get(dead, {})
    if res.evicted != (dead,) or not res.rerouted or res.epoch < 1:
        fail(f"multihost_kill: evicted {res.evicted}, re-routed {res.rerouted}, "
             f"epoch {res.epoch}: worker {dead} evicted and its requests "
             "re-routed expected")
    if not ("kill_ts" in det and "evict_ts" in det
            and det["evict_ts"] - det["kill_ts"] <= bound):
        fail(f"multihost_kill: detection {det} past the {bound} s bound")
    events = res.trace()["traceEvents"]
    windows, in_window = after_kill(events, res.retires, det, dead)
    idle = [r for r in range(MULTIHOST_RANKS) if r != dead and not windows.get(r)]
    if idle:
        fail(f"multihost_kill: survivors {idle} ran no decode window between "
             f"the kill and the eviction: detection {det}")
    if not in_window:
        fail(f"multihost_kill: no survivor retired, before the eviction, a "
             f"request it decoded after the kill: retires {res.retires}, "
             f"detection {det}")
    names = {e.get("name") for e in events}
    chain = {"host_kill", "host_suspect", "host_evict", "ulfm_shrink", "reroute",
             "epoch", "rank_failed"}
    latched = {e["pid"] for e in events if e.get("name") == "rank_failed"}
    if not chain <= names or not latched or dead in latched:
        fail(f"multihost_kill: trace chain {sorted(names & chain)} of "
             f"{sorted(chain)}, rank_failed from {sorted(latched)}")
    rank_failed = int(ErrorCode.RANK_FAILED)
    survivors = sorted(set(range(MULTIHOST_RANKS)) - {dead})
    if sorted(res.words) != survivors or not all(
            res.words[r] & rank_failed for r in survivors):
        fail(f"multihost_kill: bye words {res.words}: RANK_FAILED from each "
             f"survivor {survivors} expected")
    emit({**line, "killed": dead, "kill_at_retired": MULTIHOST_KILL_AT,
          "suspect_timeout_s": MULTIHOST_SUSPECT_TIMEOUT,
          "kill_to_suspect_s": det["suspect_ts"] - det["kill_ts"],
          "kill_to_evict_s": det["evict_ts"] - det["kill_ts"],
          "survivor_windows_in_window": {str(r): n for r, n in sorted(windows.items())},
          "survivor_retires_in_window": [[ts - det["kill_ts"], start - det["kill_ts"], r, i]
                                         for ts, start, r, i in in_window],
          "retires_after_kill_s": [[ts - det["kill_ts"], r, i] for ts, r, i in res.retires],
          "rank_failed_from": sorted(latched)})
    return paths


def phase_elastic(torch, card: str) -> None:
    """The elastic trainer (module docstring 11f): the reference's 16-dim
    regression on 4 rank threads, a NaN gradient on rank 2 at step 5 and
    rank 1 killed at step 8, once with its gradients on the card and once
    on the CPU. The survivors' events, steps and world sizes must be equal
    exactly, their weights within ``ELASTIC_RTOL``, every final loss under
    5e-2. No kernel: the model is a 16 x 1 product."""
    import numpy as np

    from repro_torch.core.faults import FaultSchedule, FaultSpec
    from repro_torch.launch.elastic import elastic_train

    faults = lambda: FaultSchedule([  # noqa: E731
        FaultSpec(step=5, kind="nan_grad", rank=2), FaultSpec(step=8, kind="kill", rank=1)])
    runs, walls = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[device] = elastic_train(4, steps=25, lr=0.2, faults=faults(), device=device)
        walls[device] = time.perf_counter() - t0
    outcome = lambda rr: (rr.rank, rr.killed, None if rr.value is None else (  # noqa: E731
        rr.value.events, rr.value.steps_done, rr.value.world_sizes))
    gpu, cpu = runs["cuda"], runs["cpu"]
    bad = [rr.rank for rr in gpu + cpu if rr.exception is not None]
    if bad or [outcome(r) for r in gpu] != [outcome(r) for r in cpu]:
        fail(f"elastic: ranks {bad} raised, or the card's run decided otherwise "
             f"than the CPU's: {[outcome(r) for r in gpu]} vs {[outcome(r) for r in cpu]}")
    if [r.rank for r in gpu if r.killed] != [1]:
        fail(f"elastic: killed {[r.rank for r in gpu if r.killed]}, [1] expected")
    survivors = [(a.value, b.value) for a, b in zip(gpu, cpu) if not a.killed]
    err = max(float(np.max(np.abs(a.weights - b.weights) / np.abs(b.weights)))
              for a, b in survivors)
    if err > ELASTIC_RTOL or not all(a.final_loss < 5e-2 for a, _ in survivors):
        fail(f"elastic: weights {err} apart (rtol {ELASTIC_RTOL}), final losses "
             f"{[a.final_loss for a, _ in survivors]}")
    emit({"phase": "elastic", "card": card, "ranks": 4, "steps": 25,
          "events": [list(map(list, a.events)) for a, _ in survivors][0],
          "steps_done": [a.steps_done for a, _ in survivors],
          "final_world": survivors[0][0].world_sizes[-1],
          "final_loss": [a.final_loss for a, _ in survivors],
          "weights_max_rel_diff": err, "wall_s": walls["cuda"],
          "cpu_wall_s": walls["cpu"], "kernels": 0})


def train_kernels(torch, cfg, leaf_specs, batch: int = TRAIN_B) -> dict:
    """The train path's kernels at its shapes (``cfg``'s heads, B x S =
    ``batch x TRAIN_S``, ``batch`` the microbatch's rows under the
    ``microbatch`` lever): where ``cfg`` has self-attention layers, the
    flash forward with its row lse (``flash_forward``; causal, at the
    sliding layers' window where it has them, or bidirectional for an
    encoder), and where it has ``cross`` layers the same over its
    ``img_tokens`` image keys, non-causal — each against the plain lse and
    its own output without lse, and FlashAttention's gradients against
    autograd through the plain version; the probe over the largest
    gradient leaf (the vocab x d_model embedding, 151936 x 2048 in bf16 for
    qwen3), and the tree probe over a gradient tree of ``leaf_specs`` (each
    leaf's shape and dtype); each timed beside its bound, its plain version
    and the library call."""
    out = {}
    kinds = set(cfg.pattern_layers)
    if kinds & {"attn", "sliding"}:
        out["flash_train_forward"] = flash_train_row(
            torch, cfg, cfg.sliding_window if "sliding" in kinds else 0,
            causal=cfg.causal, batch=batch)
    if "cross" in kinds:
        out["flash_train_forward_cross"] = flash_train_row(
            torch, cfg, 0, causal=False, keys=cfg.img_tokens, batch=batch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    out["probe_grad_embed"] = probe_grad_embed(torch, cfg, gen)
    out["probe_grad_tree"] = probe_grad_tree(torch, leaf_specs, gen)
    return out


def flash_train_row(torch, cfg, window: int, *, causal: bool = True,
                    keys: int = TRAIN_S, batch: int = TRAIN_B) -> dict:
    """:func:`train_kernels`' flash row: the forward with lse and
    FlashAttention's gradients at ``cfg``'s heads, ``batch`` x ``TRAIN_S``
    query rows over ``keys`` keys (a cross layer's image tokens), causal or not, at
    ``window`` (0: none; the library call is causal alone, the same mask
    while ``TRAIN_S`` is at most the window). The controls: the lse with
    the last key dropped, and the gradients against a mask shifted by one
    key (causal) or against the causal mask where the route has none."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import FlashAttention, sdpa_ref

    if window and window < TRAIN_S:
        fail(f"flash train row: window {window} under TRAIN_S {TRAIN_S}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 7)
    randn = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
    B, S, T = batch, TRAIN_S, keys
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = randn(B, S, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, D)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    mask = dict(causal=causal, window=window)
    before = dict(flash_attention.kernel_launches)
    got, lse = flash_attention(q, k, v, zero, **mask, lse=True)
    moved = [n for n, c in flash_attention.kernel_launches.items() if c != before[n]]
    want, want_lse = sdpa_ref(q, k, v, q_offset=zero, **mask, return_lse=True)
    a, r = LSE_TOL
    lse_excess = ((lse - want_lse).abs() / (a + r * want_lse.abs())).max().item()
    _, short_lse = sdpa_ref(q, k, v, q_offset=zero, **mask, seq_kv=T - 1,
                            return_lse=True)
    lse_control = ((lse - short_lse).abs() / (a + r * short_lse.abs())).max().item()
    same_out = torch.equal(got, flash_attention(q, k, v, zero, **mask))
    err = (got.float() - want.float()).abs().max().item()
    excess = flash_excess(got, want)
    if not (moved == ["flash_forward"] and same_out and lse_excess <= 1 < lse_control
            and err <= FLASH_TOL and excess <= 1):
        fail(f"flash forward with lse: launched {moved}, out equal without lse "
             f"{same_out}, lse {lse_excess} x its limit (control {lse_control}, "
             f"must exceed 1), out error {err} ({excess} x the relative limit)")
    # the gradients: FlashAttention (the kernel forward, the plain recompute
    # backward) against autograd through the plain version in fp32
    do = randn(B, S, Hq, D)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(FlashAttention.apply(*leaves, causal, window, 2048,
                                                     2048), leaves, do)
    ga, gr = TRAIN_GRAD_TOL

    def grad_excess(**kw):
        f = [t.float().requires_grad_() for t in (q, k, v)]
        ref = torch.autograd.grad(sdpa_ref(*f, **kw), f, do.float())
        return [((g.float() - w).abs() / (ga * w.abs().max() + gr * w.abs())).max().item()
                for g, w in zip(grads, ref)]

    g_excess = grad_excess(q_offset=zero, **mask)
    g_control = grad_excess(q_offset=zero + 1 if causal else zero, causal=True,
                            window=window)
    if not (max(g_excess) <= 1 < min(g_control)):
        fail(f"FlashAttention gradients dq, dk, dv: {g_excess} x the limit; "
             f"against the {'shifted' if causal else 'causal'} mask {g_control} "
             "(each must exceed 1)")
    nbytes = 2 * B * S * Hq * D * 2 + 2 * B * T * Hkv * D * 2 + B * S * Hq * 4 + 4 * B
    flops = (4 * Hq * D * B * S * (S + 1) // 2 if causal
             else 4 * Hq * D * B * S * T)
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    qkv = copies(lambda: (randn(B, S, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, D)),
                 B * (S * Hq + 2 * T * Hkv) * D * 2)
    heads_first = lambda *ts: tuple(t.transpose(1, 2) for t in ts)  # noqa: E731
    row = {
        "shape": f"q {B}x{S}x{Hq}x{D}, kv {B}x{T}x{Hkv}x{D} bf16, "
                 f"{'causal' if causal else 'not causal'}, window {window}, with lse",
        "kernel": "flash_forward", "source": f"{FLASH_CSRC}/flash_forward.cu",
        "max_abs_err": err, "tol": FLASH_TOL, "err_over_tol": excess,
        "lse_max_abs_err": (lse - want_lse).abs().max().item(),
        "lse_tol": f"{LSE_TOL[0]} abs + {LSE_TOL[1]} rel",
        "lse_over_tol": lse_excess, "lse_one_key_dropped_over_tol": lse_control,
        "out_equal_without_lse": same_out,
        "grad_tol": f"{ga} x max + {gr} rel", "grad_over_tol": g_excess,
        ("grad_shifted_mask_over_tol" if causal else "grad_causal_mask_over_tol"):
            g_control, "timing_copies": len(qkv),
        "kernel_ms": time_ms(torch, lambda q, k, v: flash_attention(
            q, k, v, zero, **mask, lse=True), qkv),
        # one call per copy, at most 20 (the microbatch's small copies
        # number 48): ~40 launches a call, and the device queues about 1000
        "plain_ms": time_ms(torch, lambda q, k, v: sdpa_ref(
            q, k, v, q_offset=zero, **mask, return_lse=True),
            qkv[:20], launches=min(len(qkv), 20)),
        "library_ms": time_ms(torch, lambda *t: F.scaled_dot_product_attention(
            *t, is_causal=causal, enable_gqa=True), [heads_first(*t) for t in qkv]),
        "bound_ms": b_ms, "bound_by": b_by}
    del q, k, v, do, leaves, grads, qkv
    return row


def probe_grad_embed(torch, cfg, gen) -> dict:
    """:func:`train_kernels`' probe over the largest gradient leaf, the
    vocab x d_model embedding's (drawn on the card from ``gen``: 311 M
    numbers for qwen3, too many to draw in numpy), clean, with a NaN and
    with an overflow, held bit-equal to the plain version and timed."""
    from repro_torch.core.errors import ErrorCode
    from repro_torch.kernels import probe_rows
    from repro_torch.kernels.fault_probe import probe_rows_ref

    dev = torch.device("cuda")
    rows, cols = cfg.vocab_size, cfg.d_model
    nf, ov = int(ErrorCode.NONFINITE_GRAD), int(ErrorCode.OVERFLOW)
    big = lambda: torch.randn((1, rows * cols), generator=gen, device=dev,  # noqa: E731
                              dtype=torch.bfloat16)
    x = big()
    words = {}
    for name, (i, val) in {"clean": (0, None), "nan": (rows * cols - 1, float("nan")),
                           "overflow": (rows * cols // 2, 3e4)}.items():
        if val is not None:
            keep = x[0, i].clone()
            x[0, i] = val
        got = probe_rows(x, 1e4, nonfinite_code=nf, overflow_code=ov)
        ref = probe_rows_ref(x, 1e4, nonfinite_code=nf, overflow_code=ov)
        if not torch.equal(got, ref):
            fail(f"probe over the embedding's gradient ({name}): {got.tolist()} "
                 f"vs {ref.tolist()}")
        words[name] = got.item()
        if val is not None:
            x[0, i] = keep
    if words != {"clean": 0, "nan": nf, "overflow": ov}:
        fail(f"probe over the embedding's gradient: words {words}")
    b_ms, b_by = bound(rows * cols * 2 + 4, 3 * rows * cols, PEAK_FP32_FLOPS)
    xs = [(x,), (big(),)]                                   # 1.2 GB: past the L2
    row = {
        "shape": f"1 x {rows * cols} bf16 (the {rows}x{cols} embedding's gradient), "
                 "threshold 1e4", "words": words, "max_abs_err": 0,
        "timing_copies": len(xs),
        "kernel_ms": time_ms(torch, lambda x: probe_rows(
            x, 1e4, nonfinite_code=nf, overflow_code=ov), xs),
        "plain_ms": time_ms(torch, lambda x: probe_rows_ref(
            x, 1e4, nonfinite_code=nf, overflow_code=ov), xs, launches=8),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    del x, xs
    return row


def probe_grad_tree(torch, leaf_specs, gen) -> dict:
    """The tree probe over a gradient tree of ``leaf_specs`` (full-width
    qwen3: 310 leaves, 1.72 G elements, 3.44 GB, far past the L2), drawn on
    the card from ``gen``; leaf 5 is a view at an odd element offset into
    a larger buffer, so its data is not 16-byte aligned. Held bit-equal to
    ``probe_tree_ref`` clean, with a NaN in the last element of the last
    leaf, an overflow in the first element of the first leaf and a -inf in
    the first element of the misaligned leaf: one launch a call, no leaf
    copied. Timed beside its bound and its plain version (no single
    PyTorch call computes the word)."""
    from repro_torch.core.errors import ErrorCode
    from repro_torch.kernels import probe_tree
    from repro_torch.kernels.fault_probe import probe_tree_ref

    dev = torch.device("cuda")
    nf, ov = int(ErrorCode.NONFINITE_GRAD), int(ErrorCode.OVERFLOW)
    tree = {}
    for i, (shape, dtype) in enumerate(leaf_specs):
        n = math.prod(shape)
        if i == 5:                   # a view at element 1 of n + 1
            buf = torch.randn((n + 1,), generator=gen, device=dev, dtype=dtype)
            tree[f"leaf{i}"] = buf[1:].view(shape)
        else:
            tree[f"leaf{i}"] = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
    leaves = list(tree.values())
    misaligned = leaves[5]
    if misaligned.data_ptr() % 16 == 0 or not misaligned.is_contiguous():
        fail(f"probe_grad_tree: leaf 5 at {misaligned.data_ptr()} is 16-byte "
             "aligned or not contiguous")
    words, launches = {}, []
    copies = probe_tree.copies
    for name, (leaf, i, val) in {
            "clean": (leaves[-1], 0, None),
            "nan_last_of_last": (leaves[-1], -1, float("nan")),
            "overflow_first_of_first": (leaves[0], 0, 3e4),
            "neg_inf_first_of_misaligned": (misaligned, 0, float("-inf"))}.items():
        flat = leaf.view(-1)
        if val is not None:
            keep = flat[i].clone()
            flat[i] = val
        before = probe_tree.launches
        got = probe_tree(tree, 1e4, nonfinite_code=nf, overflow_code=ov)
        launches.append(probe_tree.launches - before)
        ref = probe_tree_ref(tree, 1e4, nonfinite_code=nf, overflow_code=ov)
        if not torch.equal(got, ref):
            fail(f"probe_grad_tree ({name}): {got.item()} vs {ref.item()}")
        words[name] = got.item()
        if val is not None:
            flat[i] = keep
    want = {"clean": 0, "nan_last_of_last": nf, "overflow_first_of_first": ov,
            "neg_inf_first_of_misaligned": nf}
    if words != want or launches != [1] * 4 or probe_tree.copies != copies:
        fail(f"probe_grad_tree: words {words} (want {want}), launches a call "
             f"{launches}, leaves copied {probe_tree.copies - copies}")
    elems = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    b_ms, b_by = bound(nbytes + 4, 3 * elems, PEAK_FP32_FLOPS)
    row = {"shape": f"{len(leaves)} leaves, {elems} elements "
                    f"({nbytes / 1e9:.3f} GB; dtypes "
                    f"{dict(Counter(str(t.dtype) for t in leaves))}), threshold 1e4",
           "leaves": len(leaves), "elements": elems, "bytes": nbytes,
           "words": words, "launches_per_call": 1, "max_abs_err": 0,
           "timing_copies": 1,
           "kernel_ms": time_ms(torch, lambda t: probe_tree(
               t, 1e4, nonfinite_code=nf, overflow_code=ov), [(tree,)]),
           # ~8 launches a leaf: more than the device queues
           "plain_ms": time_ms(torch, lambda t: probe_tree_ref(
               t, 1e4, nonfinite_code=nf, overflow_code=ov), [(tree,)], launches=2,
               queued=False),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    del tree, leaves, misaligned
    return row


def train_profile(torch, step_fn, state, batch, ms_step: float) -> dict:
    """Where a train step's time goes: torch's profiler (CUPTI, device
    activity only) over one clean step from ``state`` (after one more as
    warm-up): the kernels' device time, the device's idle share of the
    unprofiled step (``ms_step``), the kernels taking the most device
    time, each with its launches, and the fault probe's time and launches."""
    from torch.profiler import ProfilerActivity, profile

    step_fn(state, batch, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step_fn(state, batch, 0)
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    probe = [(ms, n) for name, ms, n in kernels if "probe_kernel" in name]
    return {"device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1 - busy_ms / ms_step,
            "kernel_launches_per_step": sum(n for _, _, n in kernels),
            "probe_ms_per_step": sum(ms for ms, _ in probe),
            "probe_launches_per_step": sum(n for _, n in probe),
            "top_kernels": [{"name": name[:90], "ms_per_step": ms, "launches": n}
                            for name, ms, n in top]}


def phase_train(torch, card: str, model, name: str = "train", *,
                full: bool = True, line=None, start=None, levers=None,
                dryrun=None) -> tuple:
    """Full-width training on the card (module docstring 11g, 16b, 20a,
    35): runs of ``TRAIN_STEPS`` steps of ``ResilientExecutor`` over
    ``make_train_step``, each from fresh params (``start()``; default a
    copy of ``model``'s weights, the serving model not changed) with zero
    moments: clean (one sync a step, each kernel's launches a step by the
    layers' kinds, finite losses) and LFLR (bit-equal to a clean run over
    the kept batches), after the train path's attention and probe kernels
    at its shapes (:func:`train_kernels`). The batches are drawn once into
    pinned host memory, before the runs (the host's numpy draw timed
    apart: ``batch_draw_s``), and copied to the card as each step takes
    one.
    ``model`` may be a skeleton on the ``meta`` device when ``start`` is
    given. Where the stack has ``cross`` layers, the gradient of the first
    step (from ``start()`` on the first batch) must reach every cross
    layer's attention weights, non-zero and finite. ``full`` (qwen3's
    phase) adds a profiled step and the faulted run; the other stacks'
    phases leave those to qwen3's (the fault decisions do not depend on the
    architecture: the CPU tests hold them to the reference for every
    stack). The train setup has the allocator grow its segments in place
    (``launch.train.grow_segments``); the phase sets it back to fixed
    segments when it ends, so the serving phases allocate as they did
    before. ``line`` adds keys to the phase's line. ``levers``
    (``{"microbatch": k, "ce_chunk": c}``) builds the step with
    ``make_train_step``'s levers: each kernel of the forward and backward
    then launches k times a step, the probe once, and the flash row is
    held at the microbatch's rows. ``dryrun()``, where given, returns the
    dry run's record of the same step (``launch/dryrun.py::run_cell``):
    its peak must lie within 2x of the measured one either way. The line
    gives ``mfu``: ``model_flops_for`` (6 N D) over the median step's time
    at the card's dense bf16 peak. Returns ``(kernel rows, the clean run's
    launches)``."""
    from repro_torch.core import (ExecutorConfig, FaultSchedule, FaultSpec,
                                  ResilientExecutor)
    from repro_torch.core.detect import ProbeConfig
    from repro_torch.core.device_channel import readback
    from repro_torch.core.recovery import RecoveryPolicy
    from repro_torch.core.resilient import snapshot
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import launch_counts, probe_tree, reset_launch_counts
    from repro_torch.kernels.fault_probe.ops import MAX_LEAVES
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import (make_loss_and_grads, make_reset_opt_fn,
                                          make_train_step)
    from repro_torch.launch.train import build_train_setup, grow_segments
    from repro_torch.optim import init_opt_state
    from repro_torch.roofline.analysis import PEAK_FLOPS_BF16, model_flops_for
    from repro_torch.tree import tree_leaves
    from repro_torch.weights import train_params

    from repro_torch.kernels.ssd_scan.ops import plan as ssd_plan
    from repro_torch.kernels.ssd_scan.ops import plan_bwd as ssd_plan_bwd

    t_parts = {"start": time.perf_counter()}
    cfg = model.cfg
    k = max((levers or {}).get("microbatch", 0), 1)
    kern = train_kernels(torch, cfg, [(tuple(p.shape), p.dtype)
                                      for p in model.parameters()],
                         batch=TRAIN_B // k)
    t_parts["kernels"] = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated() / 1e9
    dev = torch.device("cuda")
    grow_segments()
    # on a meta skeleton the setup's state is shapes only
    probe_cfg = ProbeConfig(loss_divergence_threshold=TRAIN_DIVERGENCE)
    _, step_fn, state, pipe, opt_cfg = build_train_setup(
        cfg, batch_size=TRAIN_B, seq_len=TRAIN_S, seed=SEED, model=model,
        probe_cfg=probe_cfg)
    if levers:
        step_fn = make_train_step(cfg, opt_cfg, probe_cfg, **levers)
    n_leaves = len(state["params"])
    state_gb = sum(t.numel() * t.element_size() for t in tree_leaves(state)) / 1e9
    del state
    serving = model.device.type == "cuda"
    weights = ({n: p.detach().clone() for n, p in list(model.named_parameters())[:3]}
               if serving else {})
    start = start or (lambda: train_params(model))
    # the batches, drawn once in pinned host memory (the VLM's image
    # embeddings are 105 MB a step: kept off the card), each copied to the
    # card as a step takes it, as the pipeline's iterator copies it
    t0 = time.perf_counter()
    host_batches = [{k: v.pin_memory() for k, v in make_batch(pipe.cfg, i, "cpu").items()}
                    for i in range(TRAIN_STEPS)]
    batch_draw_s = time.perf_counter() - t0

    def batch(i: int) -> dict:
        return {k: v.to(dev, non_blocking=True) for k, v in host_batches[i].items()}

    def fresh():
        """The run's start: ``start()``'s params, zero moments."""
        params = start()
        return {"params": params, "opt": init_opt_state(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev),
                "lr_scale": torch.ones((), dtype=torch.float32, device=dev)}

    extra = dict(line or {})
    cross = [l for l, b in enumerate(cfg.pattern_layers) if b == "cross"]
    if cross:
        # a control: at the seeded gates (0) these gradients are exactly 0
        _, grads, _ = make_loss_and_grads(cfg)(start(), batch(0))
        cross_grads = {f"blocks.{l}.attn.{w}": grads[f"blocks.{l}.attn.{w}"]
                       for l in cross for w in ("wq", "wk", "wv", "wo")}
        finite = all(bool(torch.isfinite(g).all()) for g in cross_grads.values())
        extra["cross_grad_abs_max"] = {n: g.float().abs().max().item()
                                       for n, g in cross_grads.items()}
        del grads, cross_grads
        if not finite or not all(extra["cross_grad_abs_max"].values()):
            fail(f"{name}: the first step's cross-layer gradients "
                 f"{extra['cross_grad_abs_max']} (finite {finite}): each must "
                 "be finite and non-zero")

    losses = []

    def step_kept(state, batch, inject):
        new, metrics, word = step_fn(state, batch, inject)
        losses.append(metrics["loss"])
        return new, metrics, word

    def run(plan):
        ex = ResilientExecutor(step_kept, policy=RecoveryPolicy(can_shrink=False),
                               config=ExecutorConfig(good_state_interval=TRAIN_GOOD_INTERVAL),
                               reset_opt_fn=make_reset_opt_fn(cfg))
        losses.clear()
        return ex.run(fresh(), map(batch, range(TRAIN_STEPS)), TRAIN_STEPS,
                      faults=FaultSchedule([FaultSpec(step=s, kind=k) for s, k in plan]))

    # 1. clean: one host sync a step (the port's counter, and torch's sync
    #    debug mode counting every synchronising call), the kernels' launches
    torch.cuda.synchronize()
    reset_launch_counts()
    syncs, copies = readback.count, probe_tree.copies
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            state, log = run(())
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()           # the last update, queued after its word
    clean_s = time.perf_counter() - t0
    launches = launch_counts()
    syncs, copies = readback.count - syncs, probe_tree.copies - copies
    sync_sites = Counter(f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                         for w in caught
                         if "called a synchronizing CUDA operation" in str(w.message))
    torch_syncs = sum(sync_sites.values())
    clean_losses = readback(torch.stack(losses)).tolist()
    step_ms = sorted(e.duration_s * 1e3 for e in log.events if e.kind == "ok" and e.step)
    ms_step = step_ms[len(step_ms) // 2]
    # a step: the flash forward per attention layer, the RG-LRU scan and
    # its backward per RG-LRU layer, the SSD kernel and its backward per SSD
    # layer, one probe_tree launch over every gradient leaf (all fit one
    # table of MAX_LEAVES), no probe_rows
    expected = dict.fromkeys(launches, 0)
    n_rg, n_ssd = cfg.pattern_layers.count("rglru"), cfg.pattern_layers.count("ssd")
    # (under the microbatch lever, each forward and backward kernel k
    # times a step)
    n_attn = len(model.attn_layers)
    expected.update(flash_attention=TRAIN_STEPS * k * n_attn,
                    flash_forward=TRAIN_STEPS * k * n_attn,
                    rglru_scan=TRAIN_STEPS * k * n_rg,
                    rglru_scan_bwd=TRAIN_STEPS * k * n_rg,
                    ssd_scan=TRAIN_STEPS * k * n_ssd,
                    ssd_chunk_bwd=TRAIN_STEPS * k * n_ssd,
                    probe_tree=TRAIN_STEPS * math.ceil(n_leaves / MAX_LEAVES))
    if n_ssd:
        expected[ssd_plan(model.dtype)] = TRAIN_STEPS * k * n_ssd
        expected[ssd_plan_bwd(model.dtype)] = TRAIN_STEPS * k * n_ssd
    ok = [e.step for e in log.events if e.kind == "ok"]
    if (ok != list(range(TRAIN_STEPS)) or int(readback(state["step"])) != TRAIN_STEPS
            or syncs != TRAIN_STEPS or torch_syncs != TRAIN_STEPS
            or launches != expected or copies
            or not all(map(math.isfinite, clean_losses))):
        fail(f"{name} (clean): ok steps {ok}, step {int(readback(state['step']))}, "
             f"syncs {syncs} (torch's sync debug mode: {torch_syncs} at "
             f"{dict(sync_sites)}; want {TRAIN_STEPS}), launches {launches} != {expected}, "
             f"non-contiguous leaves copied {copies}, losses {clean_losses}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = snapshot(state)
    torch.cuda.synchronize()
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    del snap, state, log
    t_parts["clean"] = time.perf_counter()
    stragglers = 0
    if full:
        extra["profile"] = train_profile(torch, step_fn, fresh(), batch(0), ms_step)
        t_parts["profile"] = time.perf_counter()

        # 2. faulted: the reference policy's decisions, the constant the CPU
        #    test ties to the JAX executor
        state, log = run(TRAIN_FAULTS)
        events = tuple((e.step, e.kind, e.code, e.action) for e in log.events
                       if e.kind != "straggler")
        stragglers += sum(e.kind == "straggler" for e in log.events)
        if events != TRAIN_FAULT_EVENTS:
            fail(f"{name} (faulted): events {events} != {TRAIN_FAULT_EVENTS}")
        extra.update(faulted_losses=readback(torch.stack(losses)).tolist(),
                     fault_events=[list(e) for e in events if e[1] == "fault"])
        del state, log
        t_parts["faulted"] = time.perf_counter()

    # 3. LFLR: skip, then restore to the snapshot after step 5; bit-equal to
    #    a clean run over the kept batches (the step is deterministic)
    state, log = run(TRAIN_LFLR_FAULTS)
    stragglers += sum(e.kind == "straggler" for e in log.events)
    acts = [(e.step, e.action) for e in log.faults()]
    clean = fresh()
    for i in TRAIN_LFLR_KEPT:
        clean, _, _ = step_fn(clean, batch(i), 0)
    a, b = tree_leaves(state), tree_leaves(clean)
    equal = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    unequal = [i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
    if acts != [(3, "skip_batch"), (8, "restore_good")] or not equal:
        fail(f"{name} (LFLR): actions {acts}, leaves unequal to the clean run "
             f"over {TRAIN_LFLR_KEPT}: {len(unequal)} of {len(b)} (first {unequal[:5]})")
    del state, clean, a, b, log
    t_parts["lflr"] = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 1e9
    peak_reserved = torch.cuda.max_memory_reserved() / 1e9
    untouched = (all(torch.equal(p, weights[n]) for n, p in model.named_parameters()
                     if n in weights)
                 and not any(p.requires_grad for p in model.parameters()))
    if not untouched:
        fail(f"{name}: the serving model's weights changed or require a gradient")
    del host_batches
    if peak >= TRAIN_PEAK_GB:
        fail(f"{name}: peak {peak} GB, not under {TRAIN_PEAK_GB}")
    model_flops = model_flops_for(cfg, ShapeConfig(name, TRAIN_S, TRAIN_B, "train"))
    extra.update(model_flops=model_flops, peak_flops_bf16=PEAK_FLOPS_BF16,
                 mfu=model_flops / (ms_step / 1e3) / PEAK_FLOPS_BF16)
    if levers:
        extra.update(microbatch=k, ce_chunk=levers.get("ce_chunk", 0))
    if dryrun:
        rec = dryrun()
        if not rec.get("ok"):
            fail(f"{name}: the dry run of its step failed: {rec.get('error')}\n"
                 f"{rec.get('traceback')}")
        est = rec["memory"]["peak_live_bytes"] / 1e9
        extra["dryrun"] = {
            "peak_gb": est, "measured_over_estimate": peak / est,
            "flops": rec["flops"], "flops_over_model_flops": rec["flops"] / model_flops,
            "boundary_bytes": rec["boundary_bytes"],
            "roofline_bound_ms": max(rec["roofline"][k] for k in (
                "compute_s", "memory_s", "collective_s")) * 1e3,
            "dominant": rec["roofline"]["dominant"], "count_s": rec["total_s"]}
        if not 0.5 <= peak / est <= 2.0:
            fail(f"{name}: measured peak {peak} GB against the dry run's {est} GB: "
                 "not within 2x")
    gc.collect()
    torch.cuda.empty_cache()
    grow_segments(False)
    emit({"phase": name, "card": card, "model": cfg.name, "batch": TRAIN_B,
          "seq": TRAIN_S, "steps": TRAIN_STEPS, "leaves": n_leaves,
          "ms_per_step_median": ms_step, "ms_per_step": step_ms,
          "tokens_per_s": TRAIN_B * TRAIN_S / (ms_step / 1e3),
          "batch_draw_s": batch_draw_s,
          "clean_run_s": clean_s, "syncs_per_step": syncs / TRAIN_STEPS,
          "probe_leaves_copied": copies,
          "torch_syncs": torch_syncs, "torch_sync_sites": dict(sync_sites),
          "snapshot_ms": snapshot_ms,
          "state_gb": state_gb, "mem_before_gb": mem_before, "peak_mem_gb": peak,
          "peak_reserved_gb": peak_reserved,
          "allocator": "expandable segments (launch.train.grow_segments)",
          "losses": clean_losses, **extra,
          "lflr_bit_equal": equal, "stragglers_flagged": stragglers,
          "divergence_threshold": TRAIN_DIVERGENCE, "lr_warmup": opt_cfg.warmup_steps,
          "launches": launches, "kernels": kern,
          "seconds": time.perf_counter() - t_parts["start"],
          "seconds_by_part": {k: t_parts[k] - t_parts[j] for j, k in zip(
              list(t_parts)[:-1], list(t_parts)[1:])}})
    return kern, launches


def phase_train_cut(torch, card: str, arch: str, name: str, layers: int, *,
                    levers=None, dryrun=None) -> dict:
    """:func:`phase_train`'s clean and LFLR runs for ``arch`` at its
    published width cut to ``layers`` layers (all of them for hubert-xlarge),
    from a fresh seeded model (the serving model freed first) whose weights
    — its cross gates set to ``TRAIN_GATE`` where it has them — are copied
    to the host; the model is freed before the runs, which start from that
    copy (no seeded model stays beside the train states). The line says the
    cut, the parameter count and the init's peak. ``levers`` and ``dryrun``
    go to :func:`phase_train`. Returns ``(kernel rows, the clean run's
    launches)``."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.weights import train_params

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    line = {"layers": f"{layers} of {cfg.num_layers}"}
    cfg = cfg.replace(num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    model, line["init_s"] = build_model(torch, cfg)
    line["params_g"] = sum(p.numel() for p in model.parameters()) / 1e9
    line["init_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        gates = [g for blk in model.blocks for g in (blk.gate_attn, blk.gate_mlp)
                 if g is not None]
        for g in gates:
            g.fill_(TRAIN_GATE)
    if gates:
        line["cross_gates"] = TRAIN_GATE
    host = {n: t.cpu().pin_memory() for n, t in train_params(model).items()}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    start = lambda: {n: t.to("cuda", non_blocking=True)  # noqa: E731
                     for n, t in host.items()}
    kern, launches = phase_train(torch, card, Model(cfg, device="meta", seed=None),
                                 name, full=False, line=line, start=start,
                                 levers=levers, dryrun=dryrun)
    del host
    gc.collect()
    torch.cuda.empty_cache()
    return kern, launches


def phase_train_levers(torch, card: str) -> tuple:
    """The train step's levers on the card: recurrentgemma-2b at its
    published width cut to one period (``LEVERS_LAYERS``), B ``TRAIN_B`` x
    S ``TRAIN_S``, one state and one batch. The loss and the gradients of
    ``microbatch=LEVERS_MB, ce_chunk=LEVERS_CE`` and of
    ``ce_chunk=LEVERS_CE_RAGGED`` (a ragged last chunk) against the plain
    step's, within ``TRAIN_GRAD_TOL`` of each leaf (the plain gradients are
    bf16, the microbatches' fp32 sums of bf16 slices: the tolerance's two
    ulps and 1% of the largest cover their rounding), with a control: the
    plain gradients of another batch must exceed it. One step of each
    (counts set to 0 just before): word 0, and the flash lse forward, the
    RG-LRU scan and its backward k times the plain step's launches,
    ``probe_tree`` once. ``nan_grad`` and ``bad_data`` under the levers
    give the plain step's words. The flash lse forward and FlashAttention's
    gradients are held at the microbatch's one row first. Returns ``(kernel
    rows, the levers' step's launches)``."""
    from repro_torch.configs import get_config
    from repro_torch.core.detect import ProbeConfig
    from repro_torch.core.device_channel import readback
    from repro_torch.core.faults import INJ_BAD_DATA, INJ_NAN_GRAD
    from repro_torch.data.pipeline import PipelineConfig, make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import (accumulate_grads, make_loss_and_grads,
                                          make_train_step)
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.weights import train_params

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("recurrentgemma-2b")
    line = {"layers": f"{LEVERS_LAYERS} of {cfg.num_layers}"}
    cfg = cfg.replace(num_layers=LEVERS_LAYERS)
    model, line["init_s"] = build_model(torch, cfg)
    kern = {"flash_train_forward": flash_train_row(
        torch, cfg, cfg.sliding_window, batch=TRAIN_B // LEVERS_MB)}
    params = train_params(model)
    del model
    pipe = PipelineConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                          batch_size=TRAIN_B, seed=SEED)
    batch, other = make_batch(pipe, 0, "cuda"), make_batch(pipe, 1, "cuda")
    variants = {"plain": {}, "levers": {"microbatch": LEVERS_MB, "ce_chunk": LEVERS_CE},
                "ragged": {"ce_chunk": LEVERS_CE_RAGGED}}

    def grads_of(kw, b):
        loss_and_grads = make_loss_and_grads(cfg, kw.get("ce_chunk", 0))
        if kw.get("microbatch", 0) > 1:
            return accumulate_grads(loss_and_grads, params, b, kw["microbatch"])[:2]
        return loss_and_grads(params, b)[:2]

    want_loss, want = grads_of({}, batch)
    excess = {}
    for name in ("levers", "ragged"):
        loss, got = grads_of(variants[name], batch)
        excess[name] = {"loss": scaled_excess(loss, want_loss, TRAIN_GRAD_TOL),
                        "grads": max(scaled_excess(got[n], want[n], TRAIN_GRAD_TOL)
                                     for n in want)}
        line[f"loss_{name}"] = loss.item()
        del got
    _, control = grads_of({}, other)
    control = max(scaled_excess(control[n], want[n], TRAIN_GRAD_TOL) for n in want)
    line["loss_plain"] = want_loss.item()
    del want
    if not (max(max(e.values()) for e in excess.values()) <= 1 < control):
        fail(f"train_levers: losses and gradients over TRAIN_GRAD_TOL {excess} "
             f"(each at most 1); another batch's gradients {control} (must exceed 1)")

    state = {"params": params, "opt": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda"),
             "lr_scale": torch.ones((), dtype=torch.float32, device="cuda")}
    probe_cfg = ProbeConfig(loss_divergence_threshold=TRAIN_DIVERGENCE)
    launches, words, ms = {}, {}, {}
    for name, kw in variants.items():
        step = make_train_step(cfg, AdamWConfig(), probe_cfg, **kw)
        torch.cuda.synchronize()
        reset_launch_counts()
        word = step(state, batch, 0)[2]
        launches[name] = launch_counts()
        words[name] = {"clean": int(readback(word))}
        t0 = time.perf_counter()
        step(state, batch, 0)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        for inj, tag in ((INJ_NAN_GRAD, "nan_grad"), (INJ_BAD_DATA, "bad_data")):
            if name != "ragged":
                words[name][tag] = int(readback(step(state, batch, inj)[2]))
    n_rg = cfg.pattern_layers.count("rglru")
    n_attn = sum(b in ("attn", "sliding") for b in cfg.pattern_layers)

    def expect(k):
        out = dict.fromkeys(launches["plain"], 0)
        out.update(flash_attention=k * n_attn, flash_forward=k * n_attn,
                   rglru_scan=k * n_rg, rglru_scan_bwd=k * n_rg, probe_tree=1)
        return out

    want_launches = {"plain": expect(1), "levers": expect(LEVERS_MB), "ragged": expect(1)}
    if (launches != want_launches or any(w["clean"] for w in words.values())
            or words["levers"]["nan_grad"] != words["plain"]["nan_grad"]
            or words["levers"]["bad_data"] != words["plain"]["bad_data"]
            or not words["plain"]["nan_grad"] or not words["plain"]["bad_data"]):
        fail(f"train_levers: launches {launches} (want {want_launches}); words {words} "
             "(clean 0; nan_grad and bad_data non-zero and equal to the plain step's)")
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_levers", "card": card, "model": cfg.name, **line,
          "batch": TRAIN_B, "seq": TRAIN_S, "microbatch": LEVERS_MB,
          "ce_chunk": LEVERS_CE, "ce_chunk_ragged": LEVERS_CE_RAGGED,
          "tol": "{} x the largest |want| + {} rel, each leaf".format(*TRAIN_GRAD_TOL),
          "over_tol": excess, "other_batch_grads_over_tol": control,
          "words": words, "launches": launches, "ms_per_step": ms,
          "kernels": kern})
    return kern, launches["levers"]


def start_dryruns(cells):
    """Start the dry run of each ``(name, arch, layers)`` train step, B
    ``TRAIN_B`` x S ``TRAIN_S`` with the levers ``TRAIN_MICROBATCH`` and
    ``TRAIN_CE_CHUNK``, in a process of its own on the host's CPU (it runs
    beside the card's phases: fake tensors, no card, no memory); returns
    ``result(name)``, which waits for the process and gives that cell's
    record. The process is killed if the run ends first."""
    import atexit

    out = os.path.join(ROOT, "build", "chip_smoke_dryrun.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    code = (
        "import json, sys, warnings\n"
        "warnings.simplefilter('ignore')\n"
        "from repro_torch.configs import ShapeConfig, get_config\n"
        "from repro_torch.launch.dryrun import run_cell\n"
        "cells, b, s, perf, out = json.loads(sys.argv[1])\n"
        "recs = {name: run_cell(arch, ShapeConfig(name, s, b, 'train'), perf=perf,\n"
        "                        config_override=get_config(arch).replace(num_layers=n))\n"
        "        for name, arch, n in cells}\n"
        "json.dump(recs, open(out, 'w'))\n")
    perf = {"microbatch": TRAIN_MICROBATCH, "ce_chunk": TRAIN_CE_CHUNK}
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen([sys.executable, "-c", code,
                             json.dumps([cells, TRAIN_B, TRAIN_S, perf, out])], env=env)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    recs = {}

    def result(name: str) -> dict:
        if not recs:
            if proc.wait(timeout=900):
                fail(f"the dry run's process exited with {proc.returncode}")
            with open(out) as f:
                recs.update(json.load(f))
        return recs[name]

    return result


def phase_spec_deep(torch, card: str, model) -> dict:
    """Drafts that both match and miss. Under the seeded init the tied
    embedding's term dominates the residual stream, so every exit depth of
    qwen3 predicts the token it was given: the serve traffic's drafts all
    match, at any ``draft_layers``. Here the embedding is drawn at
    ``SPEC_DEEP_EMBED`` of its init scale (restored after), so the layers
    move the argmax, and a draft from ``num_layers - 1`` layers matches the
    full model only in part. The engines traffic goes through the overlap
    engine and the speculative one with that draft on the same weights: the
    streams must be equal, syncs at most 2 a window, the draft's decode
    kernel 3 x 27 times a step, and drafts both accepted and rejected.
    Returns the speculative run's launches."""
    from repro_torch.serve import Request

    cfg = model.cfg
    spec = dict(SPEC, draft_layers=cfg.num_layers - 1)
    embed = model.embed.detach().clone()
    with torch.no_grad():
        model.embed.mul_(SPEC_DEEP_EMBED)
    model.tie_unembed()
    try:
        plain = serve_engine(torch, model, ENGINES["overlap"], engine_requests(cfg, Request))
        run = serve_engine(torch, model, dict(ENGINES["overlap"], **spec),
                           engine_requests(cfg, Request))
    finally:
        with torch.no_grad():
            model.embed.copy_(embed)
        model.tie_unembed()
        del embed
    out, m = run["answers"], run["metrics"]
    bad = [i for i in plain["answers"] if out.get(i) is None or not out[i].ok
           or out[i].tokens != plain["answers"][i].tokens]
    if bad or m.faults:
        fail(f"serve_spec_deep: streams differ from the overlap engine's for "
             f"requests {bad}, faults {m.faults}")
    if run["syncs"] > 2 * m.windows:
        fail(f"serve_spec_deep: {run['syncs']} host syncs for {m.windows} windows")
    steps = m.decode_steps
    expected = dict.fromkeys(run["launches"], 0)
    expected.update(spec_launches(model, spec, steps))
    if run["launches"] != expected:
        fail(f"serve_spec_deep: kernel launches {run['launches']} != {expected}")
    rejected = m.draft_tokens - m.accepted_draft_tokens
    SERVE_LINES["serve_spec_deep"] = {"accepted": m.accepted_draft_tokens,
                                      "rejected": rejected}
    tokens = sum(len(r.tokens) for r in out.values())
    pm = plain["metrics"]
    emit({"phase": "serve_spec_deep", "card": card, "model": cfg.name,
          "embed_scale": SPEC_DEEP_EMBED, "config": dict(ENGINES["overlap"], **spec),
          "requests": ENGINE_REQUESTS, "tokens": tokens, "wall_s": run["wall"],
          "tokens_per_s": tokens / run["wall"], "windows": m.windows, "steps": steps,
          "ms_per_step": run["wall"] / steps * 1e3, "syncs": run["syncs"],
          "drafted": m.draft_tokens, "accepted": m.accepted_draft_tokens,
          "rejected": rejected, "acceptance_rate": m.acceptance_rate(),
          "launches": run["launches"],
          "overlap_tokens_per_s": tokens / plain["wall"],
          "overlap_ms_per_step": plain["wall"] / pm.decode_steps * 1e3,
          "overlap_windows": pm.windows, "streams_equal_overlap": True})
    return run["launches"]


def phase_engines_paged(torch, card: str, model, want: dict) -> dict:
    """The engines phase's traffic through the blocking window engine over
    the page pool (``window=8, overlap=False, paged=True``): every answer
    OK, the streams equal the contiguous blocking engine's (``want``), host
    syncs within the blocking rule (2 per window, 2 per blocking prefill),
    one slot step per decode step and per prefilled token, and every page
    back at drain. Returns the run's launches."""
    from repro_torch.serve import Request

    cfg = model.cfg
    reqs = engine_requests(cfg, Request)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    conf = dict(ENGINES["blocking"], **PAGED)
    run = serve_engine(torch, model, conf, reqs)
    out, m = run["answers"], run["metrics"]
    bad = [i for i in want if out.get(i) is None or not out[i].ok
           or out[i].tokens != want[i]]
    if bad or m.faults:
        fail(f"engines_paged: streams differ from the blocking engine's for "
             f"requests {bad}, faults {m.faults}")
    if m.prefills != ENGINE_REQUESTS or run["syncs"] > 2 * m.windows + 2 * m.prefills:
        fail(f"engines_paged: {run['syncs']} host syncs for {m.windows} windows "
             f"and {m.prefills} prefills")
    slot_steps = m.decode_steps + prompt_tokens
    expected = dict.fromkeys(run["launches"], 0)
    expected.update({"flash_attention": len(model.attn_layers) * slot_steps,
                     "flash_decode": len(model.attn_layers) * slot_steps,
                     "probe_rows": slot_steps})
    if run["launches"] != expected:
        fail(f"engines_paged: kernel launches {run['launches']} != {expected}")
    if not m.pages_allocated or m.pages_allocated != m.pages_freed:
        fail(f"engines_paged: pages allocated {m.pages_allocated}, freed "
             f"{m.pages_freed}")
    tokens = sum(len(r.tokens) for r in out.values())
    emit({"phase": "engines_paged", "card": card, "model": cfg.name,
          "config": conf, "requests": ENGINE_REQUESTS, "tokens": tokens,
          "wall_s": run["wall"], "tokens_per_s": tokens / run["wall"],
          "steps": m.decode_steps,
          "ms_per_step": (run["wall"] - m.host_stall_s) / m.decode_steps * 1e3,
          "windows": m.windows, "syncs": run["syncs"], "prefills": m.prefills,
          "prefill_ms_per_call": m.host_stall_s / m.host_stalls * 1e3,
          "host_stall_s": m.host_stall_s, "pages_allocated": m.pages_allocated,
          "launches": run["launches"], "streams_equal_blocking": True})
    return run["launches"]


def phase_lflr_engine(torch, card: str, model, name: str, conf: dict,
                      clean: dict, n: int = ENGINE_REQUESTS) -> None:
    """An engine of the engines phase on the same traffic with one injected
    fault: the probe latches it on the poisoned slot and every stream is
    bit-equal to that engine's clean run (``clean``)."""
    from repro_torch.core.errors import ErrorCode
    from repro_torch.serve import Request

    cfg = model.cfg
    inject, state = injector(conf["window"] or 1, 2, ENGINE_NEW)
    run = serve_engine(torch, model, conf, engine_requests(cfg, Request, n),
                       inject=inject)
    out, m = run["answers"], run["metrics"]
    if not run["injected"]:
        fail(f"{name}: no decoding slot to poison")
    code = (ErrorCode.STATE_FAULT if model.state_leaves
            else ErrorCode.NONFINITE_LOSS)
    latched = [f for f in m.faults if f.code & int(code)]
    if not latched or state["slot"] not in latched[0].slots:
        fail(f"{name}: the probe did not latch {code.name} on slot "
             f"{state['slot']}: {m.faults}")
    diff = [i for i in clean if out.get(i) is None or not out[i].ok
            or out[i].tokens != clean[i]]
    if diff:
        fail(f"{name}: streams differ from the clean run for requests {diff}")
    emit({"phase": name, "card": card, "model": cfg.name, "config": conf,
          "requests": n, "poisoned_slot": state["slot"],
          "poisoned_layers": state["layers"], "latched": code.name,
          "faults": [{"step": f.step, "code": f.code, "action": f.action,
                      "slots": list(f.slots)} for f in m.faults],
          "retries": sum(r.retries for r in out.values()),
          "prefills": m.prefills, "host_stall_s": m.host_stall_s,
          "streams_bit_equal": True, "wall_s": run["wall"]})


def phase_lflr_stepwise_rg(torch, card: str, model, n: int = 4) -> None:
    """recurrentgemma's stepwise engine, clean and with a NaN in ``h``: the
    re-prefill rebuilds the lane's (batch, layer) state rows through the
    scratch cache, and the streams are bit-equal."""
    from repro_torch.serve import Request

    conf = ENGINES["stepwise"]
    clean = serve_engine(torch, model, conf, engine_requests(model.cfg, Request, n))
    if not all(r.ok for r in clean["answers"].values()):
        fail("lflr_stepwise_rg: the clean stepwise run failed a request")
    phase_lflr_engine(torch, card, model, "lflr_stepwise_rg", conf,
                      streams(clean["answers"]), n)


def check_against_forward(torch, model, answers, reqs, longest: bool = False) -> dict:
    """Hold one served stream, the shortest prompt's (or the longest's),
    against the prefill step's full forward (the flash kernel at prefill
    shape; for recurrentgemma and mamba2 the scan kernels where decode runs
    the one-step update): every served token must be the forward's argmax,
    or within ``FORWARD_GAP_TOL`` of it (bf16 decode and forward round
    differently over the layers). The SSD scan takes a multiple of its
    chunk, so the sequence is padded at its end; the forward is causal, so
    the padding changes none of the rows read."""
    from repro_torch.launch.steps import make_prefill_step
    req = (max if longest else min)(reqs, key=lambda r: len(r.prompt))
    toks = list(req.prompt) + list(answers[req.id].tokens)
    chunk = model.cfg.ssm_chunk
    pad = -len(toks) % chunk if "ssd" in model.cfg.block_pattern else 0
    logits, word = make_prefill_step(model)(
        torch.tensor([toks + [0] * pad], device=model.device))
    logits = logits[0]
    if int(word) != 0 or not bool(torch.isfinite(logits).all()):
        fail(f"forward logits are not finite (word {int(word)})")
    n = len(req.prompt)
    rows = logits[n - 1:len(toks) - 1]

    served = torch.tensor(answers[req.id].tokens, device=model.device)
    gap = (rows.max(dim=-1).values - rows.gather(1, served[:, None])[:, 0])
    agree = int((gap == 0).sum())
    worst = float(gap.max())
    if worst > FORWARD_GAP_TOL:
        fail(f"served stream of request {req.id} disagrees with the forward "
             f"(largest logit gap {worst})")
    return {"request": req.id, "prompt": len(req.prompt),
            "positions": len(served), "argmax_agree": agree,
            "max_gap": worst, "tol": FORWARD_GAP_TOL}


@contextlib.contextmanager
def recorded_routing():
    """Every MoE layer's expert choice while the block is open: a list that
    gets, per ``apply_moe`` call, its experts (B, S, K) sorted within each
    token and each token's gap between its K-th and (K+1)-th router
    probability (B, S) (``models/moe.py::route`` wrapped for the block's
    time)."""
    import repro_torch.models.moe as moe
    calls, route = [], moe.route

    def recording(p, x, cfg):
        gates, experts = route(p, x, cfg)
        K = cfg.num_experts_per_tok
        top = (x.float() @ p.router).softmax(dim=-1).topk(K + 1, dim=-1).values
        calls.append((experts.sort(dim=-1).values, top[..., K - 1] - top[..., K]))
        return gates, experts

    moe.route = recording
    try:
        yield calls
    finally:
        moe.route = route


def check_moe_against_forward(torch, model, answers, reqs, gate: bool) -> dict:
    """The shortest request's served stream against the MoE model's forward.

    The forward drops tokens past each expert's capacity and the decode
    (one token a row) never does, so the comparison runs below L*, a prefix
    whose forward drops nothing (:func:`drop_free_prefix`; at least
    ``MOE_FORWARD_MIN`` served positions). The prefix's tokens then run
    through ``decode_step`` one by one at the slots' batch (every row the
    sequence), with each MoE layer's experts recorded, as in the forward:
    the decode's argmax must be the served token (the engine serves the
    decode step's stream), and the line reports where the decode's and the
    forward's expert choices part (``(position, layer)``, first in that
    order, with the forward's gap between its K-th and (K+1)-th router
    probability there). With ``gate`` the served tokens must also be within
    ``FORWARD_GAP_TOL`` of the forward's argmax and the two must choose the
    same experts everywhere below L*: in fp32, where rounding moves a
    router probability by ~1e-8. In bf16 the two round the router's input
    apart by an ulp, the 128-way softmax of the seeded router leaves the
    K-th and (K+1)-th experts ~1e-4 apart, and a swapped expert moves the
    residual by the gate's share of two experts' outputs: the comparison is
    reported, not gated (PERF.md §6)."""
    from repro_torch.launch.steps import make_prefill_step
    req = min(reqs, key=lambda r: len(r.prompt))
    served = list(answers[req.id].tokens)
    toks, n = list(req.prompt) + served, len(req.prompt)
    length, line = drop_free_prefix(torch, model, toks, n)
    seq = toks[:length]
    layers = model.cfg.num_layers
    with recorded_routing() as calls:
        logits, word = make_prefill_step(model)(torch.tensor([seq], device=model.device))
        fwd = [(e[0], g[0]) for e, g in calls]          # per layer (L*, K), (L*,)
        calls.clear()
        cache = model.init_cache(NUM_SLOTS, MAX_LEN)
        dec_argmax = []
        with torch.no_grad():
            for p in range(length):
                tok = torch.full((NUM_SLOTS, 1), seq[p], dtype=torch.int32,
                                 device=model.device)
                dec_argmax.append(model.decode_step(tok, cache, p)[0, 0].argmax())
        dec = [torch.stack([calls[p * layers + l][0][0, 0] for p in range(length)])
               for l in range(layers)]
    logits = logits[0]
    if int(word) != 0 or not bool(torch.isfinite(logits).all()):
        fail(f"MoE forward logits are not finite (word {int(word)})")
    rows = logits[n - 1:length]
    want = torch.tensor(served[:length - n + 1], device=model.device)
    if not torch.equal(torch.stack(dec_argmax[n - 1:]), want):
        fail(f"request {req.id}: the decode loop's argmax is not the served stream")
    gap = rows.max(dim=-1).values - rows.gather(1, want[:, None])[:, 0]
    parted = sorted((p, l) for l in range(layers)
                    for p in (fwd[l][0] != dec[l]).any(dim=-1).nonzero().flatten().tolist())
    gaps = torch.stack([g for _, g in fwd])             # (layers, L*)
    first = {}
    if parted:
        p, l = parted[0]
        first = {"position": p, "layer": l, "forward_router_gap": float(gaps[l, p])}
    line = {"request": req.id, "prompt": n, "positions": len(want),
            "argmax_agree": int((gap == 0).sum()), "max_gap": float(gap.max()),
            "tol": FORWARD_GAP_TOL, "gated": gate,
            "routing_parted": len(parted), "routing_decisions": layers * length,
            "first_parted": first, "router_gap_median": float(gaps.median()),
            **line}
    if gate and (line["max_gap"] > FORWARD_GAP_TOL or parted):
        fail(f"request {req.id}: the decode parts from the MoE forward below its "
             f"drop-free prefix: {line}")
    return line


def drop_free_prefix(torch, model, toks: list, n: int) -> tuple:
    """The length L* of a prefix of ``toks`` (prompt of ``n`` tokens, then
    the served ones) whose MoE forward drops no token, found by bisection
    between ``n`` and ``len(toks) - 1`` on the forward's dropped fraction:
    its rows are the drop-free arithmetic the decode does (position s keeps
    or drops by the positions up to s only, and attention is causal). The
    capacity steps up with the length, so the fraction is not monotone
    everywhere and L* is a drop-free prefix, not always the longest. Fails
    if it leaves fewer than ``MOE_FORWARD_MIN`` served positions. Returns
    ``(L*, the line's fields)``: L*, the fraction at the full length and
    the lengths whose forward ran."""
    calls = []

    def dropped(length: int) -> float:
        with torch.no_grad():
            _, aux = model(torch.tensor([toks[:length]], device=model.device),
                           with_aux=True)
        calls.append(length)
        return float(aux["dropped_fraction"])

    full = len(toks) - 1
    at_full = dropped(full)
    lo = full
    if at_full > 0:
        if dropped(n) > 0:
            fail(f"MoE forward check: the prompt alone ({n} tokens) drops tokens")
        lo, hi = n, full                  # dropped(lo) == 0 < dropped(hi)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if dropped(mid) > 0:
                hi = mid
            else:
                lo = mid
    if lo - n + 1 < MOE_FORWARD_MIN:
        fail(f"MoE forward check: the drop-free prefix of {lo} tokens holds "
             f"{lo - n + 1} served positions, fewer than {MOE_FORWARD_MIN}")
    return lo, {"drop_free_prefix": lo, "full_length": full,
                "dropped_at_full": at_full, "forward_lengths": calls}


def check_moe_fp32_stream(torch, cfg) -> dict:
    """The MoE forward check's gate: ``cfg`` at full width, cut to
    ``MOE_FP32_LAYERS`` layers, in fp32 and seeded on the card, serves the
    short request through serve's engine, and :func:`check_moe_against_forward`
    holds its stream to the fp32 forward (flash's fp32 route) within
    ``FORWARD_GAP_TOL`` and the expert choices to the forward's, below the
    drop-free prefix. Frees the model after."""
    from repro_torch.models import Model
    from repro_torch.serve import EngineConfig, Replica, Request

    wide = Model(cfg.replace(dtype="float32", num_layers=MOE_FP32_LAYERS),
                 device="cuda", seed=SEED)
    reqs = make_requests(cfg, Request, n=0, short=1)
    rep = Replica(wide.cfg, wide, config=EngineConfig(
        window=WINDOW, overlap=True, num_slots=NUM_SLOTS, max_len=MAX_LEN))
    answers, _ = drive(rep, reqs)
    if not all(r.ok and len(r.tokens) == MAX_NEW for r in answers.values()):
        fail("MoE fp32 check: the short request was not answered in full")
    out = {"layers": MOE_FP32_LAYERS,
           **check_moe_against_forward(torch, wide, answers, reqs, gate=True)}
    del rep, wide
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_fp32_stream(torch, model, reqs) -> dict:
    """``model``'s weights widened to fp32 (exactly) serve the shortest
    request through the same engine, and that stream is held against the
    fp32 prefill forward at ``FORWARD_GAP_TOL``: the full-width check that
    the chunked kernel path (the SSD scan's fp32 route, ``ssd_f32``) and the
    recurrent decode agree."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import Model
    from repro_torch.serve import EngineConfig, Replica

    wide = Model(model.cfg.replace(dtype="float32"), device=model.device, seed=None)
    with torch.no_grad():
        for (name, p32), p in zip(wide.named_parameters(), model.parameters()):
            if p32.shape != p.shape:
                fail(f"fp32 copy: {name} is {tuple(p32.shape)}, not {tuple(p.shape)}")
            p32.copy_(p.float())
    wide.tie_unembed()
    req = min(reqs, key=lambda r: len(r.prompt))
    rep = Replica(wide.cfg, wide, config=EngineConfig(
        window=WINDOW, overlap=True, num_slots=NUM_SLOTS, max_len=MAX_LEN))
    answers, _ = drive(rep, [req])
    if not answers[req.id].ok or len(answers[req.id].tokens) != MAX_NEW:
        fail(f"fp32 copy: request {req.id} not answered in full")
    before = dict(ssd_scan.kernel_launches)
    out = check_against_forward(torch, wide, answers, [req])
    out["ssd_launches"] = {k: n - before[k] for k, n in ssd_scan.kernel_launches.items()}
    if out["ssd_launches"] != {"ssd_chunk_tc": 0, "ssd_f32": wide.cfg.pattern_layers.count("ssd")}:
        fail(f"fp32 forward: SSD launches {out['ssd_launches']}, not one ssd_f32 "
             "launch per layer")
    del rep, wide
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_kernels_rg(torch, card: str) -> dict:
    """Each kernel against its plain version at recurrentgemma-2b's shapes,
    the scan's backward at the prefill and the train shapes."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.errors import ErrorCode
    from repro_torch.kernels import flash_attention, probe_rows, rglru_scan
    from repro_torch.kernels.fault_probe import probe_rows_ref
    from repro_torch.kernels.flash_attention import sdpa_ref
    from repro_torch.kernels.rglru_scan import (rglru_scan_backward_ref, rglru_scan_bwd,
                                                rglru_scan_ref)
    from repro_torch.kernels.rglru_scan.ops import CHUNK

    cfg = get_config("recurrentgemma-2b")
    dev = torch.device("cuda")
    # made on the card from a seed: the prefill logits alone are 2.1e9 values
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    f32 = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=gen, device=dev, dtype=torch.float32)
    randn = lambda *shape: f32(*shape).to(torch.bfloat16)  # noqa: E731
    heads_first = lambda *ts: tuple(t.transpose(1, 2) for t in ts)  # noqa: E731
    out = {}

    # -- RG-LRU scan at the prefill shape; log_a as the model makes it,
    #    -8 softplus(lam) sigmoid(.), lam spanning the model's init
    #    (softplus 0.9 to 4: a chunk's decay product is 0 in fp32) and, for
    #    long memory, the Griffin paper's a^8 in [0.9, 0.999]
    B, S, W, T = PREFILL_B, PREFILL_S, cfg.resolved_lru_width, CHUNK

    def make_for(lo, hi, b=B, s=S):
        lam = torch.log(torch.expm1(torch.linspace(lo, hi, W, device=dev)))
        return lambda: (f32(b, s, W), (-8.0 * F.softplus(lam)
                                       * torch.sigmoid(f32(b, s, W))).contiguous())
    make = make_for(0.9, 4.0)
    x_in, log_a = make()
    got = rglru_scan(x_in, log_a)
    want = rglru_scan_ref(x_in, log_a)
    limit = SCAN_TOL + SCAN_TOL * want.abs()
    err = (got - want).abs().max().item()
    excess = ((got - want).abs() / limit).max().item()
    # control: one step's log_a halved (batch 0, mid-sequence, channel 0,
    # the longest memory), against the plain version on the unchanged inputs
    bad = log_a.clone()
    bad[0, S // 2 + 5, 0] *= 0.5
    control = ((rglru_scan(x_in, bad) - want).abs() / limit).max().item()
    if not excess <= 1 < control:
        fail(f"rglru_scan: max error {err}, {excess} x the limit; one log_a "
             f"halved reads {control} x (must exceed 1)")
    # long memory: chunks 2 onward see chunk 0 only through chunk 1's decay
    # product (up to about 0.94 here), so the carry decides them. Control,
    # over those chunks: one log_a of chunk 0 set to -1
    x_in, log_a = make_for(-math.log(0.999) / 8, -math.log(0.9) / 8)()
    got = rglru_scan(x_in, log_a)
    want = rglru_scan_ref(x_in, log_a)
    limit = SCAN_TOL + SCAN_TOL * want.abs()
    long_err = (got - want).abs().max().item()
    long_excess = ((got - want).abs() / limit).max().item()
    bad = log_a.clone()
    bad[0, T - 8, 0] = -1.0
    later = slice(2 * T, S)
    long_control = ((rglru_scan(x_in, bad)[:, later] - want[:, later]).abs()
                    / limit[:, later]).max().item()
    if not long_excess <= 1 < long_control:
        fail(f"rglru_scan, long memory: max error {long_err}, {long_excess} x "
             f"the limit; one log_a of chunk 0 set to -1 reads {long_control} x "
             f"over chunks 2 onward (must exceed 1)")
    del bad, limit, x_in, log_a, got, want
    b_ms, b_by = bound(3 * B * S * W * 4, 10 * B * S * W, PEAK_FP32_FLOPS)
    ins = copies(make, 2 * B * S * W * 4)
    out["rglru_scan"] = {
        "shape": f"x_in, log_a {B}x{S}x{W} fp32", "max_abs_err": err,
        "tol": f"{SCAN_TOL} abs + {SCAN_TOL} rel", "err_over_tol": excess,
        "one_log_a_halved_over_tol": control, "chunk": T, "chunks": -(-S // T),
        # three launches: chunk aggregates, carries, carry-in and re-scan;
        # the inputs are read twice, 20 bytes per element against the bound's 12
        "design_bytes_ms": 20 * B * S * W / PEAK_BYTES_PER_S * 1e3,
        "timing_copies": len(ins),
        "kernel_ms": time_ms(torch, rglru_scan, ins),
        "plain_ms": time_ms(torch, rglru_scan_ref, ins, launches=4, queued=False),
        "plain_timing": "unqueued: one launch per time step, more than the "
                        "device queues; includes the host's launch gaps",
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    del ins
    out["rglru_scan_long_memory"] = {
        "shape": f"x_in, log_a {B}x{S}x{W} fp32, a^8 in [0.9, 0.999]",
        "max_abs_err": long_err, "err_over_tol": long_excess,
        "chunk_0_log_a_changed_over_tol_after_chunk_1": long_control}
    # one row at the reference's prefill_32k length: 256 chunks, whose
    # carries the middle launch folds one after another
    ins = copies(make_for(0.9, 4.0, 1, PREFILL_32K), 2 * PREFILL_32K * W * 4)
    out["rglru_scan"]["at_32k"] = {
        "shape": f"x_in, log_a 1x{PREFILL_32K}x{W} fp32",
        "chunks": -(-PREFILL_32K // T), "kernel_ms": time_ms(torch, rglru_scan, ins),
        "bound_ms": bound(3 * PREFILL_32K * W * 4, 10 * PREFILL_32K * W,
                          PEAK_FP32_FLOPS)[0]}
    del ins

    # -- the scan's backward (training) at the prefill shape and the train
    #    shape: the states from the forward kernel, dh normal
    def make_bwd_for(lo, hi, b, s):
        make = make_for(lo, hi, b, s)

        def one():
            x_in, log_a = make()
            return x_in, log_a, rglru_scan(x_in, log_a), f32(b, s, W)
        return one

    def bwd_excess(got, want, over=slice(None)):
        return max(scaled_excess(g[:, over], w[:, over], SCAN_BWD_TOL)
                   for g, w in zip(got, want))

    mb = TRAIN_B // TRAIN_MICROBATCH
    for name, b, s in (("rglru_scan_bwd", B, S), ("rglru_scan_bwd_train", TRAIN_B, TRAIN_S),
                       ("rglru_scan_bwd_microbatch", mb, TRAIN_S)):
        ins = make_bwd_for(0.9, 4.0, b, s)()
        # the forward kernel's states (ins[2]) against the plain scan, with
        # the same control as the backward's
        want_h = rglru_scan_ref(*ins[:2])
        limit = SCAN_TOL + SCAN_TOL * want_h.abs()
        fwd_err = (ins[2] - want_h).abs().max().item()
        fwd_excess = ((ins[2] - want_h).abs() / limit).max().item()
        got = rglru_scan_bwd(*ins)
        want = rglru_scan_backward_ref(*ins)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        excess = bwd_excess(got, want)
        repeat = all(torch.equal(g, a) for g, a in zip(got, rglru_scan_bwd(*ins)))
        # control: one step's log_a halved (batch 0, mid-sequence, channel 0)
        bad = ins[1].clone()
        bad[0, s // 2 + 5, 0] *= 0.5
        control = bwd_excess(rglru_scan_bwd(ins[0], bad, *ins[2:]), want)
        fwd_control = ((rglru_scan(ins[0], bad) - want_h).abs() / limit).max().item()
        if not (excess <= 1 < control and repeat and fwd_excess <= 1 < fwd_control):
            fail(f"{name}: max error {err}, {excess} x the limit; one log_a "
                 f"halved reads {control} x (must exceed 1); repeats bit for "
                 f"bit: {repeat}; its forward {fwd_excess} x the limit, control "
                 f"{fwd_control} x (must exceed 1)")
        if s == TRAIN_S:
            out[name.replace("_bwd", "")] = {
                "kernel": "rglru_scan", "shape": f"x_in, log_a {b}x{s}x{W} fp32",
                "max_abs_err": fwd_err, "tol": f"{SCAN_TOL} abs + {SCAN_TOL} rel",
                "err_over_tol": fwd_excess, "one_log_a_halved_over_tol": fwd_control}
        del ins, got, want, bad, want_h, limit
        # reads x_in, log_a, h, dh; writes dx_in, dlog_a; ~20 operations
        b_ms, b_by = bound(24 * b * s * W, 20 * b * s * W, PEAK_FP32_FLOPS)
        ins = copies(make_bwd_for(0.9, 4.0, b, s), 16 * b * s * W)
        out[name] = {
            "kernel": "rglru_scan_bwd",
            "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan_bwd.cu",
            "shape": f"x_in, log_a, h, dh {b}x{s}x{W} fp32", "max_abs_err": err,
            "tol": "{} of the largest |want| + {} rel".format(*SCAN_BWD_TOL),
            "err_over_tol": excess, "one_log_a_halved_over_tol": control,
            "repeats_bit_for_bit": repeat, "chunk": T, "chunks": -(-s // T),
            # one launch: each input read once and each output written
            # once, the bound's 24 bytes an element (plus one h row a
            # chunk and the carries' 8 bytes a chunk and channel)
            "design_bytes_ms": 24 * b * s * W / PEAK_BYTES_PER_S * 1e3,
            "timing_copies": len(ins),
            "kernel_ms": time_ms(torch, rglru_scan_bwd, ins),
            "plain_ms": time_ms(torch, rglru_scan_backward_ref, ins, launches=4,
                                queued=False),
            "plain_timing": "unqueued: one launch per time step, more than the "
                            "device queues; includes the host's launch gaps",
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        del ins
    # long memory: chunks 0 .. nc - 3 see the last chunk only through chunk
    # nc - 2's decay product, so the carry decides them. Control, over those
    # chunks: one log_a of the last chunk set to -1
    ins = make_bwd_for(-math.log(0.999) / 8, -math.log(0.9) / 8, B, S)()
    got = rglru_scan_bwd(*ins)
    want = rglru_scan_backward_ref(*ins)
    long_err = max((g - w).abs().max().item() for g, w in zip(got, want))
    long_excess = bwd_excess(got, want)
    bad = ins[1].clone()
    bad[0, S - T + 8, 0] = -1.0
    earlier = slice(0, S - 2 * T)
    long_control = bwd_excess(rglru_scan_bwd(ins[0], bad, *ins[2:]), want, earlier)
    if not long_excess <= 1 < long_control:
        fail(f"rglru_scan_bwd, long memory: max error {long_err}, {long_excess} "
             f"x the limit; one log_a of the last chunk set to -1 reads "
             f"{long_control} x over the chunks before the last two (must exceed 1)")
    out["rglru_scan_bwd_long_memory"] = {
        "kernel": "rglru_scan_bwd",
        "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan_bwd.cu",
        "shape": f"x_in, log_a, h, dh {B}x{S}x{W} fp32, a^8 in [0.9, 0.999]",
        "design_bytes_ms": 24 * B * S * W / PEAK_BYTES_PER_S * 1e3,
        "max_abs_err": long_err, "err_over_tol": long_excess,
        "last_chunk_log_a_changed_over_tol_before_the_last_two": long_control}
    del ins, got, want, bad

    # -- flash decode over ring caches: one query row per slot, positions
    #    past the ring's capacity (it has wrapped; the read is index < min(cap, pos+1))
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    cap = cfg.sliding_window
    pos = [0, 1, 700, cap - 1, cap, 3000, 4500, 6000]
    q, k, v = randn(NUM_SLOTS, 1, Hq, D), randn(NUM_SLOTS, cap, Hkv, D), randn(NUM_SLOTS, cap, Hkv, D)
    off = torch.tensor(pos, dtype=torch.int32, device=dev)
    got, route = flash_call(flash_attention, q, k, v, off, causal=True, seq_kv=cap)
    want = sdpa_ref(q, k, v, q_offset=off, causal=True, seq_kv=cap)
    err = (got.float() - want.float()).abs().max().item()
    excess = flash_excess(got, want)
    # control: the ring's last slot dropped, one key of 2048 for the rows
    # whose ring is full
    control = flash_excess(flash_attention(q, k, v, off, causal=True,
                                           seq_kv=cap - 1), want)
    if not excess <= 1 < control:
        fail(f"flash ring decode: error {err}, {excess} x the limit; one "
             f"key dropped reads {control} x (must exceed 1)")
    kpos = torch.arange(cap, device=dev)
    mask = (kpos[None, :] <= off[:, None])[:, None, None, :]
    ctx = [min(p + 1, cap) for p in pos]
    b_ms, b_by = bound(2 * NUM_SLOTS * Hq * D * 2 + 2 * sum(ctx) * Hkv * D * 2
                       + 4 * NUM_SLOTS, sum(4 * Hq * c * D for c in ctx),
                       PEAK_BF16_FLOPS)
    qkv = copies(lambda: (randn(NUM_SLOTS, 1, Hq, D), randn(NUM_SLOTS, cap, Hkv, D),
                          randn(NUM_SLOTS, cap, Hkv, D)),
                 (NUM_SLOTS * Hq + 2 * NUM_SLOTS * cap * Hkv) * D * 2)
    out["flash_ring_decode"] = {
        "shape": f"q {NUM_SLOTS}x1x{Hq}x{D}, ring kv {NUM_SLOTS}x{cap}x{Hkv}x{D} "
                 f"bf16, pos {pos}", **route,
        "max_abs_err": err, "tol": f"{FLASH_RG_TOL[0]} abs + {FLASH_RG_TOL[1]} rel",
        "err_over_tol": excess, "one_key_dropped_over_tol": control,
        "timing_copies": len(qkv),
        "kernel_ms": time_ms(torch, lambda q, k, v: flash_attention(
            q, k, v, off, causal=True, seq_kv=cap), qkv),
        "plain_ms": time_ms(torch, lambda q, k, v: sdpa_ref(
            q, k, v, q_offset=off, causal=True, seq_kv=cap), qkv),
        "library_ms": time_ms(torch, lambda *t: F.scaled_dot_product_attention(
            *t, attn_mask=mask, enable_gqa=True), [heads_first(*t) for t in qkv]),
        "bound_ms": b_ms, "bound_by": b_by}
    del q, k, v, got, want, qkv

    # -- flash sliding forward at the prefill shape: S 2x the window, so the
    #    window mask and the tile skip both act
    Bp, Sp, win = PREFILL_B, PREFILL_S, cfg.sliding_window
    q, k, v = randn(Bp, Sp, Hq, D), randn(Bp, Sp, Hkv, D), randn(Bp, Sp, Hkv, D)
    zero = torch.zeros(Bp, dtype=torch.int32, device=dev)
    got, route = flash_call(flash_attention, q, k, v, zero, causal=True, window=win)
    want = sdpa_ref(q, k, v, q_offset=zero, causal=True, window=win)
    err = (got.float() - want.float()).abs().max().item()
    excess = flash_excess(got, want)
    # control: a window one short, the oldest key dropped from rows >= win - 1
    control = flash_excess(flash_attention(q, k, v, zero, causal=True,
                                           window=win - 1), want)
    if not excess <= 1 < control:
        fail(f"flash sliding forward: error {err}, {excess} x the limit; one "
             f"key dropped reads {control} x (must exceed 1)")
    del got, want
    qp = torch.arange(Sp, device=dev)
    mask = (qp[None, :] <= qp[:, None]) & (qp[None, :] > qp[:, None] - win)
    keys = sum(min(s + 1, win) for s in range(Sp))          # per (batch, head)
    b_ms, b_by = bound(2 * Bp * Sp * Hq * D * 2 + 2 * Bp * Sp * Hkv * D * 2 + 4 * Bp,
                       4 * Bp * Hq * D * keys, PEAK_BF16_FLOPS)
    qkv = copies(lambda: (randn(Bp, Sp, Hq, D), randn(Bp, Sp, Hkv, D),
                          randn(Bp, Sp, Hkv, D)), Bp * Sp * (Hq + 2 * Hkv) * D * 2)
    out["flash_sliding_forward"] = {
        "shape": f"q {Bp}x{Sp}x{Hq}x{D}, kv {Bp}x{Sp}x{Hkv}x{D} bf16, causal, "
                 f"window {win}", **route,
        "max_abs_err": err, "tol": f"{FLASH_RG_TOL[0]} abs + {FLASH_RG_TOL[1]} rel",
        "err_over_tol": excess, "one_key_dropped_over_tol": control,
        "timing_copies": len(qkv),
        "kernel_ms": time_ms(torch, lambda q, k, v: flash_attention(
            q, k, v, zero, causal=True, window=win), qkv),
        "plain_ms": time_ms(torch, lambda q, k, v: sdpa_ref(
            q, k, v, q_offset=zero, causal=True, window=win), qkv, launches=8),
        "library_ms": time_ms(torch, lambda *t: F.scaled_dot_product_attention(
            *t, attn_mask=mask, enable_gqa=True), [heads_first(*t) for t in qkv]),
        "bound_ms": b_ms, "bound_by": b_by}
    del q, k, v, qkv, mask

    # -- the probe over the recurrent state h (slots, rglru layers * width)
    n_rec = sum(b == "rglru" for b in cfg.pattern_layers)
    cols = n_rec * W
    sf = int(ErrorCode.STATE_FAULT)
    h = f32(NUM_SLOTS, cols)
    h[2, 5] = float("nan")
    h[5, cols - 1] = float("inf")
    got = probe_rows(h, math.inf, nonfinite_code=sf, overflow_code=sf)
    want = probe_rows_ref(h, math.inf, nonfinite_code=sf, overflow_code=sf)
    if not torch.equal(got, want) or got.tolist() != [0, 0, sf, 0, 0, sf, 0, 0]:
        fail(f"probe_rows over h wrong: {got.tolist()} vs {want.tolist()}")
    hs = copies(lambda: (f32(NUM_SLOTS, cols),), NUM_SLOTS * cols * 4)
    b_ms, b_by = bound(NUM_SLOTS * cols * 4 + NUM_SLOTS * 4, 3 * NUM_SLOTS * cols,
                       PEAK_FP32_FLOPS)
    out["probe_state"] = {
        "shape": f"h {NUM_SLOTS}x{cols} fp32, threshold inf", "words": got.tolist(),
        "max_abs_err": (got - want).abs().max().item(), "timing_copies": len(hs),
        "kernel_ms": time_ms(torch, lambda x: probe_rows(
            x, math.inf, nonfinite_code=sf, overflow_code=sf), hs),
        "plain_ms": time_ms(torch, lambda x: probe_rows_ref(
            x, math.inf, nonfinite_code=sf, overflow_code=sf), hs),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    del h, hs

    # -- the probe over the prefill logits (B * S, vocab) fp32
    out["probe_prefill"] = probe_prefill_row(torch, gen, cfg.vocab_size)
    emit({"phase": "kernels_rg", "card": card, **out})
    return out


def flash_row(torch, randn, name, note, qs, kvs, off, kw, controls, kv_keys,
              flop_keys, lib_kw, plain_launches=32, check=None) -> dict:
    """One bf16 flash shape (q ``qs``, K and V ``kvs``, each ``(B, S, H,
    D)``, drawn by ``randn``): the kernel against its plain version (and
    each control, which must exceed the limit), its time, the plain
    version's, the library call's and the bound. ``kv_keys``: the keys each
    K/V element read once counts; ``flop_keys``: the keys attended over all
    query rows. ``check(q, k, v, out)``, where given, runs a further gate
    on the kernel's output and returns fields for the row."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import sdpa_ref

    Hq, D, Hkv = qs[2], qs[3], kvs[2]
    heads_first = lambda *ts: tuple(t.transpose(1, 2) for t in ts)  # noqa: E731
    ref_kw = {n: x for n, x in kw.items() if n != "verify"}
    q, k, v = randn(*qs), randn(*kvs), randn(*kvs)
    got, route = flash_call(flash_attention, q, k, v, off, **kw)
    want = sdpa_ref(q, k, v, q_offset=off, **ref_kw)
    extra = check(q, k, v, got) if check else {}
    err = (got.float() - want.float()).abs().max().item()
    excess = flash_excess(got, want)
    ctl = {label: flash_excess(fn(q, k, v), want) for label, fn in controls.items()}
    if not excess <= 1 < min(ctl.values()):
        fail(f"{name}: error {err}, {excess} x the limit; controls {ctl} "
             "(each must exceed 1)")
    del q, k, v, got, want
    b_ms, b_by = bound(2 * math.prod(qs) * 2 + 2 * kv_keys * Hkv * D * 2 + 4 * qs[0],
                       4 * Hq * D * flop_keys, PEAK_BF16_FLOPS)
    qkv = copies(lambda: (randn(*qs), randn(*kvs), randn(*kvs)),
                 (math.prod(qs) + 2 * math.prod(kvs)) * 2)
    row = {
        "shape": note, **route, "max_abs_err": err,
        "tol": f"{FLASH_RG_TOL[0]} abs + {FLASH_RG_TOL[1]} rel",
        "err_over_tol": excess, **{f"{c}_over_tol": x for c, x in ctl.items()},
        **extra, "timing_copies": len(qkv),
        "kernel_ms": time_ms(torch, lambda q, k, v: flash_attention(q, k, v, off, **kw), qkv),
        "plain_ms": time_ms(torch, lambda q, k, v: sdpa_ref(q, k, v, q_offset=off, **ref_kw),
                            qkv, launches=plain_launches),
        "library_ms": time_ms(torch, lambda *t: F.scaled_dot_product_attention(
            *t, enable_gqa=True, **lib_kw), [heads_first(*t) for t in qkv]),
        "bound_ms": b_ms, "bound_by": b_by}
    del qkv
    torch.cuda.empty_cache()
    return row


def flash_decode_row(torch, randn, name, Hq, Hkv, D, cap, pos) -> dict:
    """:func:`flash_row` for the decode: one query row for each of the
    ``len(pos)`` slots at its position over a cache (or ring) of ``cap``
    entries, which reads index < min(cap, pos + 1); controls: the last key
    dropped, and the key after the first split boundary replaced by the
    one before it (where the cache has more than one split)."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention.ops import plan

    dev = torch.device("cuda")
    off = torch.tensor(pos, dtype=torch.int32, device=dev)
    kpos = torch.arange(cap, device=dev)
    mask = (kpos[None, :] <= off[:, None])[:, None, None, :]
    B, ctx = len(pos), sum(min(p + 1, cap) for p in pos)
    kw = {"causal": True, "seq_kv": cap}
    controls = {"one_key_dropped": lambda q, k, v: flash_attention(
        q, k, v, off, causal=True, seq_kv=cap - 1)}
    edge = plan(1, cap, Hkv, torch.bfloat16).keys_per_split
    if edge < cap:
        controls[f"key_{edge}_doubled"] = lambda q, k, v: flash_attention(
            q, *key_doubled(k, v, edge), off, causal=True, seq_kv=cap)
    return flash_row(torch, randn, name, f"q {B}x1x{Hq}x{D}, kv {B}x{cap}x{Hkv}x{D} "
                     f"bf16, pos {pos}", (B, 1, Hq, D), (B, cap, Hkv, D), off, kw,
                     controls, ctx, ctx, {"attn_mask": mask})


def phase_kernels_g3(torch, card: str) -> dict:
    """flash and the probe against their plain versions at gemma3-1b's
    shapes (4/1 heads of 256): decode over the full cache and over the
    ring (wrapped), the sliding and the full forward at the prefill shape,
    the probe over the serve logits and over the prefill logits (2^31
    elements). Each flash row has controls that must exceed the limit."""
    from repro_torch.configs import get_config
    from repro_torch.core.errors import ErrorCode
    from repro_torch.kernels import flash_attention, probe_rows
    from repro_torch.kernels.fault_probe import probe_rows_ref

    cfg = get_config("gemma3-1b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    f32 = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=gen, device=dev, dtype=torch.float32)
    randn = lambda *shape: f32(*shape).to(torch.bfloat16)  # noqa: E731
    Hq, Hkv, D, win = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.sliding_window
    out = {}

    # -- decode over the full layers' cache (cap MAX_LEN) and the ring (cap
    #    = the window, wrapped past it): the read is index < min(cap, pos + 1)
    for name, cap, pos in (
            ("flash_g3_decode", MAX_LEN, [0, 1, 300, 511, 512, 1000, MAX_LEN - 1, 1500]),
            ("flash_g3_ring_decode", win, [0, 1, win - 1, win, 600, 1023, 1024, 2000])):
        out[name] = flash_decode_row(torch, randn, name, Hq, Hkv, D, cap, pos)

    # -- the forward at the prefill shape: sliding (window 512) and full
    Bp, Sp = PREFILL_B, PREFILL_S
    zero = torch.zeros(Bp, dtype=torch.int32, device=dev)
    qp = torch.arange(Sp, device=dev)
    mask = (qp[None, :] <= qp[:, None]) & (qp[None, :] > qp[:, None] - win)
    out["flash_g3_sliding_forward"] = flash_row(
        torch, randn, "flash_g3_sliding_forward",
        f"q {Bp}x{Sp}x{Hq}x{D}, kv {Bp}x{Sp}x{Hkv}x{D} bf16, causal, window {win}",
        (Bp, Sp, Hq, D), (Bp, Sp, Hkv, D), zero, {"causal": True, "window": win},
        {"window_one_short": lambda q, k, v: flash_attention(
            q, k, v, zero, causal=True, window=win - 1)},
        Bp * Sp, Bp * sum(min(s + 1, win) for s in range(Sp)), {"attn_mask": mask},
        plain_launches=8)
    del mask
    out["flash_g3_forward"] = flash_row(
        torch, randn, "flash_g3_forward",
        f"q {Bp}x{Sp}x{Hq}x{D}, kv {Bp}x{Sp}x{Hkv}x{D} bf16, causal",
        (Bp, Sp, Hq, D), (Bp, Sp, Hkv, D), zero, {"causal": True},
        {"one_key_dropped": lambda q, k, v: flash_attention(
            q, k, v, zero, causal=True, seq_kv=Sp - 1)},
        Bp * Sp, Bp * Sp * (Sp + 1) // 2, {"is_causal": True}, plain_launches=8)

    # -- the probe over the serve logits (slots, vocab 262144) fp32
    V = cfg.vocab_size
    out["probe_g3_logits"] = probe_logits_row(torch, gen, V)
    torch.cuda.empty_cache()

    # -- the probe over the prefill logits (B * S, vocab) fp32: 2^31
    #    elements, 8 GiB; a NaN at the last one and an inf past row 4096
    nf, ov = int(ErrorCode.NONFINITE_LOSS), int(ErrorCode.DIVERGENCE)
    rows = PREFILL_B * PREFILL_S
    x = f32(rows, V)
    x[rows - 1, V - 1] = float("nan")
    x[PREFILL_S + 5, 7] = float("inf")
    got = probe_rows(x, math.inf, nonfinite_code=nf, overflow_code=ov)
    want = probe_rows_ref(x, math.inf, nonfinite_code=nf, overflow_code=ov)
    hit = got.nonzero().flatten().tolist()
    if not torch.equal(got, want) or hit != [PREFILL_S + 5, rows - 1] or (
            got[hit].tolist() != [nf, nf]):
        fail(f"probe_rows over gemma3's prefill logits wrong: words at {hit}, "
             f"{got[hit].tolist()}")
    err = (got - want).abs().max().item()
    del x, got, want
    torch.cuda.empty_cache()
    xs = copies(lambda: (f32(rows, V),), rows * V * 4)
    b_ms, b_by = bound(rows * V * 4 + rows * 4, 3 * rows * V, PEAK_FP32_FLOPS)
    out["probe_g3_prefill"] = {
        "shape": f"logits {rows}x{V} fp32 (2^31 elements), threshold inf",
        "words_at": hit, "max_abs_err": err, "timing_copies": len(xs),
        "kernel_ms": time_ms(torch, lambda x: probe_rows(
            x, math.inf, nonfinite_code=nf, overflow_code=ov), xs),
        "plain_ms": time_ms(torch, lambda x: probe_rows_ref(
            x, math.inf, nonfinite_code=nf, overflow_code=ov), xs, launches=8),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    del xs
    torch.cuda.empty_cache()
    emit({"phase": "kernels_g3", "card": card, **out})
    return out


SSD_CSRC = "src/repro_torch/kernels/ssd_scan/csrc"


def phase_kernels_ssm(torch, card: str) -> dict:
    """The SSD kernels and the probe against their plain versions at
    mamba2-2.7b's shapes, the SSD backward at the prefill and the train
    shapes."""
    from repro_torch.configs import get_config
    from repro_torch.core.errors import ErrorCode
    from repro_torch.kernels import probe_rows, ssd_scan
    from repro_torch.kernels.fault_probe import probe_rows_ref
    from repro_torch.kernels.ssd_scan import (ssd_chunk_bwd, ssd_intra_chunk,
                                              ssd_intra_chunk_backward_ref,
                                              ssd_intra_chunk_ref, ssd_scan_ref)
    from repro_torch.kernels.ssd_scan.ops import plan, plan_bwd

    cfg = get_config("mamba2-2.7b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    f32 = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=gen, device=dev, dtype=torch.float32)
    out = {}

    def inputs(b, s, h, p, g, n, dtype=torch.bfloat16):
        """The mixer's operands, drawn like the JAX package's SSD test:
        x, B, C in the model dtype, dt = softplus(normal), A = -exp(0.3
        normal) in fp32."""
        return (f32(b, s, h, p).to(dtype),
                torch.nn.functional.softplus(f32(b, s, h)),
                -torch.exp(0.3 * f32(h)),
                (0.5 * f32(b, s, g, n)).to(dtype), (0.5 * f32(b, s, g, n)).to(dtype))

    def check(name, shape, chunk, dtype=torch.bfloat16):
        """The kernel's outputs (fp32) and the whole scan (in ``dtype``)
        against their plain versions; returns the errors over the limits
        and the kernel (route) the wrapper launched."""
        x, dt, A, B, C = inputs(*shape, dtype)
        L = min(chunk, shape[1])
        before = dict(ssd_scan.kernel_launches)
        y, st = ssd_intra_chunk(x, dt, A, B, C, chunk)
        moved = [k for k, n in ssd_scan.kernel_launches.items() if n != before[k]]
        if moved != [plan(dtype)]:
            fail(f"ssd_scan at {name} launched {moved}, not {plan(dtype)}")
        want_y, want_st = ssd_intra_chunk_ref(x, dt, A, B, C, L)
        intra = max(scaled_excess(y, want_y, SSD_TOL),
                    scaled_excess(st, want_st, SSD_TOL))
        err = max((y - want_y).abs().max().item(), (st - want_st).abs().max().item())
        del y, st, want_y, want_st
        scan_tol = SSD_BF16_TOL if dtype == torch.bfloat16 else SSD_TOL
        want = ssd_scan_ref(x, dt, A, B, C, chunk=chunk)
        got = ssd_scan(x, dt, A, B, C, chunk=chunk)
        scan = scaled_excess(got, want, scan_tol)
        # control: one step's dt doubled (batch 0, a step mid-sequence, a
        # head mid-way), against the plain version on the unchanged inputs
        bad = dt.clone()
        bad[0, shape[1] // 2 + 5, shape[2] // 2] *= 2
        control = scaled_excess(ssd_scan(x, bad, A, B, C, chunk=chunk), want, scan_tol)
        if not (intra <= 1 and scan <= 1 < control):
            fail(f"ssd_scan at {name}: kernel {intra} x, scan {scan} x the "
                 f"limit; one dt doubled reads {control} x (must exceed 1)")
        return {"kernel": moved[0], "source": f"{SSD_CSRC}/{moved[0]}.cu",
                "max_abs_err": err, "err_over_tol": intra,
                "scan_err_over_tol": scan, "one_dt_doubled_over_tol": control,
                "scan_max_abs_err": (got.float() - want.float()).abs().max().item()}

    # -- at the prefill shape, bf16 (the tensor-core route) and fp32
    b, s, h, p = PREFILL_B, PREFILL_S, cfg.ssm_nheads, cfg.ssm_head_dim
    g, n, L = cfg.ssm_ngroups, cfg.ssm_state_dim, cfg.ssm_chunk
    shape = (b, s, h, p, g, n)
    nc = s // L
    # the least work: C B^T once per group, the causal half of each L x L
    # product (L (L + 1) / 2 pairs)
    flops = b * nc * (g * n * L * (L + 1) + h * (p * L * (L + 1) + 2 * p * L * n))
    for name, dtype, peak in (("ssd_scan", torch.bfloat16, PEAK_BF16_FLOPS),
                              ("ssd_f32", torch.float32, PEAK_FP32_FLOPS)):
        res = check(f"the prefill shape ({dtype})", shape, L, dtype)
        e = 2 if dtype == torch.bfloat16 else 4          # x, B, C element
        nbytes = (b * s * h * p * e + b * s * h * 4 + h * 4 + 2 * b * s * g * n * e
                  + b * s * h * p * 4 + b * nc * h * p * n * 4)
        b_ms, b_by = bound(nbytes, flops, peak)
        ins = copies(lambda: inputs(*shape, dtype), b * s * (h * p * e + h * 4 + 2 * g * n * e))
        tname = "bf16" if dtype == torch.bfloat16 else "fp32"
        out[name] = {
            "shape": f"x {b}x{s}x{h}x{p} {tname}, dt {b}x{s}x{h} fp32, B, C "
                     f"{b}x{s}x{g}x{n} {tname}, chunk {L}",
            "tol": f"intra-chunk fp32: {SSD_TOL[0]} max + {SSD_TOL[1]} rel; scan "
                   f"{tname}: " + ("{} max + {} rel".format(
                       *(SSD_BF16_TOL if dtype == torch.bfloat16 else SSD_TOL))),
            **res, "timing_copies": len(ins),
            "kernel_ms": time_ms(torch, lambda *a: ssd_intra_chunk(*a, L), ins),
            "plain_ms": time_ms(torch, lambda *a: ssd_intra_chunk_ref(*a, L), ins,
                                launches=8),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bound_counts": f"bytes: x, B, C {tname}, dt fp32 read, y and the states "
                            "fp32 written; operations: C B^T once per group, the "
                            "causal half of each L x L product (the least work), at "
                            f"the {'bf16 tensor-core' if peak == PEAK_BF16_FLOPS else 'fp32 CUDA-core'} peak",
            "scan_ms": time_ms(torch, lambda *a: ssd_scan(*a, chunk=L), ins),
            "scan_plain_ms": time_ms(torch, lambda *a: ssd_scan_ref(*a, chunk=L), ins,
                                     launches=8)}
        if dtype == torch.bfloat16:
            # the same least work on the CUDA cores, as the fp32 route bounds it
            out[name]["fp32_core_bound_ms"] = flops / PEAK_FP32_FLOPS * 1e3
        del ins
        torch.cuda.empty_cache()
    # -- the backward (training): x, B, C in bf16 as the model's (the
    #    tensor-core route) at the prefill and the train shapes, and in fp32
    #    (the CUDA-core route) at the train shape; normal gradients of
    #    y_diag and the chunk states
    def bwd_inputs(shape, dtype):
        b_, s_, h_, p_, g_, n_ = shape
        L_ = min(L, s_)
        return (*inputs(*shape, dtype), L_, f32(b_, s_, h_, p_), f32(b_, s_ // L_, h_, p_, n_))

    def bwd_excess(got, want):
        return max(scaled_excess(g_, w_, SSD_TOL) for g_, w_ in zip(got, want))

    train_shape = (TRAIN_B, TRAIN_S, h, p, g, n)
    mb_shape = (TRAIN_B // TRAIN_MICROBATCH, TRAIN_S, h, p, g, n)
    for name, shape, dtype in (("ssd_chunk_bwd", shape, torch.bfloat16),
                               ("ssd_chunk_bwd_train", train_shape, torch.bfloat16),
                               ("ssd_chunk_bwd_microbatch", mb_shape, torch.bfloat16),
                               ("ssd_chunk_bwd_f32", train_shape, torch.float32)):
        b_, s_ = shape[:2]
        nc_ = s_ // min(L, s_)
        bf16 = dtype == torch.bfloat16
        ins = bwd_inputs(shape, dtype)
        before = dict(ssd_chunk_bwd.kernel_launches)
        got = ssd_chunk_bwd(*ins)
        moved = [k for k, v in ssd_chunk_bwd.kernel_launches.items() if v != before[k]]
        if moved != [plan_bwd(dtype)]:
            fail(f"{name}: ssd_chunk_bwd launched {moved}, not {plan_bwd(dtype)}")
        want = ssd_intra_chunk_backward_ref(*ins)
        err = max((g_ - w_).abs().max().item() for g_, w_ in zip(got, want))
        excess = bwd_excess(got, want)
        repeat = all(torch.equal(g_, a_) for g_, a_ in zip(got, ssd_chunk_bwd(*ins)))
        # control: one step's dt doubled (batch 0, mid-sequence, a head mid-way)
        bad = ins[1].clone()
        bad[0, s_ // 2 + 5, h // 2] *= 2
        control = bwd_excess(ssd_chunk_bwd(ins[0], bad, *ins[2:]), want)
        if not (excess <= 1 < control and repeat):
            fail(f"{name}: {excess} x the limit, max error {err}; one dt doubled "
                 f"reads {control} x (must exceed 1); repeats bit for bit: {repeat}")
        del ins, got, want, bad
        # the least work: C B^T once per group and the causal half of each
        # L x L product, and the two L x P x N products of the state's
        # gradient; bytes: x, B, C, dt, A, dy_diag, dstates read, the five
        # gradients (dB, dC per group) written in fp32
        e = 2 if bf16 else 4                   # x, B, C element
        bflops = b_ * nc_ * (g * n * L * (L + 1) + h * (2 * p * L * (L + 1)
                                                      + 2 * n * L * (L + 1) + 4 * L * p * n))
        nbytes = (b_ * s_ * h * p * (e + 4 + 4) + b_ * s_ * h * 8 + 2 * h * 4
                  + b_ * s_ * g * n * (e + e + 4 + 4) + b_ * nc_ * h * p * n * 4)
        b_ms, b_by = bound(nbytes, bflops, PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)
        ins = copies(lambda: bwd_inputs(shape, dtype),
                     b_ * s_ * h * p * (e + 4) + b_ * nc_ * h * p * n * 4)
        tname = "bf16" if bf16 else "fp32"
        out[name] = {
            "kernel": moved[0],
            "source": f"{SSD_CSRC}/{'ssd_chunk_bwd_tc' if bf16 else 'ssd_chunk_bwd'}.cu",
            "shape": f"x {b_}x{s_}x{h}x{p} {tname}, dt {b_}x{s_}x{h} fp32, B, C "
                     f"{b_}x{s_}x{g}x{n} {tname}, chunk {L}; dy_diag fp32, dstates "
                     f"{b_}x{nc_}x{h}x{p}x{n} fp32",
            "tol": "{} of the largest |want| + {} rel, each gradient".format(*SSD_TOL),
            "max_abs_err": err, "err_over_tol": excess,
            "one_dt_doubled_over_tol": control, "repeats_bit_for_bit": repeat,
            "timing_copies": len(ins),
            "kernel_ms": time_ms(torch, ssd_chunk_bwd, ins),
            # at most 8 calls: the plain backward's launches, times the
            # microbatch's many small copies, would outgrow the device queue
            "plain_ms": time_ms(torch, ssd_intra_chunk_backward_ref, ins[:8],
                                launches=8),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bound_counts": "operations: C B^T once per group, the causal half of "
                            "each L x L product, the state gradient's two L x P x N "
                            "products, at the "
                            + ("bf16 tensor-core" if bf16 else "fp32 CUDA-core")
                            + f" peak; bytes: x, B, C {tname}, dt, A, dy_diag, dstates "
                            "read, the gradients (dB, dC per group) written in fp32"}
        if bf16:
            # the same least work on the CUDA cores, as the fp32 route bounds it
            out[name]["fp32_core_bound_ms"] = bflops / PEAK_FP32_FLOPS * 1e3
        del ins
        torch.cuda.empty_cache()

    # -- at the train shape (nc 2), as the train step launches it
    out["ssd_scan_train"] = {
        "shape": f"x {TRAIN_B}x{TRAIN_S}x{h}x{p} bf16, B, C {TRAIN_B}x{TRAIN_S}x{g}x{n} "
                 f"bf16, chunk {L}",
        **check("the train shape", (TRAIN_B, TRAIN_S, h, p, g, n), L)}
    # -- at the microbatch's rows, as the train step launches it under the
    #    microbatch lever
    out["ssd_scan_microbatch"] = {
        "shape": f"x {mb_shape[0]}x{TRAIN_S}x{h}x{p} bf16, B, C "
                 f"{mb_shape[0]}x{TRAIN_S}x{g}x{n} bf16, chunk {L}",
        **check("the microbatch shape", mb_shape, L)}

    # -- groups over heads, fewer steps than the chunk
    shape = (3, 96, 16, p, 4, n)
    out["ssd_scan_groups"] = {
        "shape": f"x 3x96x16x{p} bf16, B, C 3x96x4x{n} bf16, chunk {L} "
                 "(one chunk of 96 steps)", **check("G > 1, S < chunk", shape, L)}

    # -- the probe over the ssm state (slots, ssd layers * H * P * N)
    cols = cfg.num_layers * h * p * n
    sf = int(ErrorCode.STATE_FAULT)
    st = f32(NUM_SLOTS, cols)
    st[1, 0] = float("nan")
    st[6, cols - 1] = float("-inf")
    got = probe_rows(st, math.inf, nonfinite_code=sf, overflow_code=sf)
    want = probe_rows_ref(st, math.inf, nonfinite_code=sf, overflow_code=sf)
    if not torch.equal(got, want) or got.tolist() != [0, sf, 0, 0, 0, 0, sf, 0]:
        fail(f"probe_rows over ssm wrong: {got.tolist()} vs {want.tolist()}")
    err = (got - want).abs().max().item()
    del st
    sts = copies(lambda: (f32(NUM_SLOTS, cols),), NUM_SLOTS * cols * 4)
    b_ms, b_by = bound(NUM_SLOTS * cols * 4 + NUM_SLOTS * 4, 3 * NUM_SLOTS * cols,
                       PEAK_FP32_FLOPS)
    out["probe_ssm"] = {
        "shape": f"ssm {NUM_SLOTS}x{cols} fp32, threshold inf", "words": got.tolist(),
        "max_abs_err": err, "timing_copies": len(sts),
        "kernel_ms": time_ms(torch, lambda x: probe_rows(
            x, math.inf, nonfinite_code=sf, overflow_code=sf), sts),
        "plain_ms": time_ms(torch, lambda x: probe_rows_ref(
            x, math.inf, nonfinite_code=sf, overflow_code=sf), sts, launches=8),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    del sts
    torch.cuda.empty_cache()
    emit({"phase": "kernels_ssm", "card": card, **out})
    return out


def phase_prefill(torch, card: str, model, name: str, embeds=None,
                  poison=None) -> dict:
    """The prefill phases: the prefill step at (PREFILL_B, PREFILL_S), counts
    from 0. ``embeds`` passes the step its embeddings (``inputs_embeds``
    in place of the tokens, or ``img_embeds`` beside them, bf16 on the
    card); ``poison`` then names one of them: after the timed calls a NaN
    goes into batch row 0's element ``(0, POISON_AT...)`` of it, and the
    step's word must latch NONFINITE_LOSS while batch row 1's logits stay
    finite (an encoder's every row of batch 0 must go non-finite: its
    attention is bidirectional)."""
    import numpy as np
    from repro_torch.core.device_channel import readback
    from repro_torch.core.errors import ErrorCode
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import make_prefill_step

    cfg = model.cfg
    step = make_prefill_step(model)
    rng = np.random.default_rng(SEED + 2)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S)).astype(np.int64)).to(model.device)
    embeds = dict(embeds or {})
    if "inputs_embeds" in embeds:
        tokens = None
    run = lambda: step(tokens, **embeds)  # noqa: E731
    logits, word = run()                             # warm-up (cuBLAS plans)
    del logits, word
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    logits, word = run()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    # each scan kernel once per layer of its kind (the SSD scan through its
    # bf16 tensor-core kernel), flash once per attention layer through the
    # bf16 forward kernel, one probe over the logits
    expected = dict.fromkeys(launches, 0)
    expected.update({"rglru_scan": cfg.pattern_layers.count("rglru"),
                     "ssd_scan": cfg.pattern_layers.count("ssd"),
                     "ssd_chunk_tc": cfg.pattern_layers.count("ssd"),
                     "flash_attention": len(model.attn_layers),
                     "flash_forward": len(model.attn_layers), "probe_rows": 1})
    if launches != expected:
        fail(f"{name}: kernel launches {launches} != {expected}")
    shape = tuple(logits.shape)
    if shape != (PREFILL_B, PREFILL_S, cfg.vocab_size) or logits.dtype != torch.float32:
        fail(f"{name}: logits {logits.dtype} {shape}")
    w = int(readback(word))
    if w != 0:
        fail(f"{name}: clean prefill raised word {w:#x}")
    del logits, word
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, word = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del logits, word
    line = {}
    if poison is not None:
        x = embeds[poison] = embeds[poison].clone()
        x[(0,) + POISON_AT] = float("nan")
        logits, word = run()
        w_nan = int(readback(word))
        finite = torch.isfinite(logits).all(dim=-1)          # (B, S)
        rows0 = int((~finite[0]).sum())
        if (w_nan != int(ErrorCode.NONFINITE_LOSS) or not bool(finite[1].all())
                or rows0 == 0 or (cfg.is_encoder and rows0 != PREFILL_S)):
            fail(f"{name}: a NaN in {poison} row 0 gave word {w_nan:#x}, "
                 f"{rows0} of {PREFILL_S} non-finite rows in batch 0, batch 1 "
                 f"finite {bool(finite[1].all())}")
        line = {"nan_gate": {"poisoned": f"{poison}[0, {', '.join(map(str, POISON_AT))}]",
                             "word": w_nan, "batch0_nonfinite_rows": rows0,
                             "batch1_finite": True}}
        del logits, word
    emit({"phase": name, "card": card, "model": cfg.name,
          "batch": PREFILL_B, "seq": PREFILL_S, "launches": launches,
          **{f"{k}_shape": list(v.shape) for k, v in embeds.items()},
          "mlp_activation": activation_cost(torch, model),
          "word": w, "first_ms": first_ms, "ms_per_call": sum(times) / len(times),
          "ms_calls": times, "tokens_per_s": PREFILL_B * PREFILL_S / (min(times) / 1e3),
          "peak_mem_gb": peak, "logits_gb": PREFILL_B * PREFILL_S * cfg.vocab_size * 4 / 1e9,
          **line})
    return launches


def phase_kernels_moe(torch, card: str) -> dict:
    """flash decode at qwen3-moe-30b-a3b's head layout (8 slots, 32/4 heads
    of 128: group 8, which no other path launches; the full cache) against
    its plain version, with its controls, time and bound."""
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    randn = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)
    out = {"flash_moe_decode": flash_decode_row(
        torch, randn, "flash_moe_decode", cfg.num_heads, cfg.num_kv_heads,
        cfg.resolved_head_dim, MAX_LEN, [0, 1, 100, 511, 700, 1022, MAX_LEN - 1, 1500])}
    emit({"phase": "kernels_moe", "card": card, **out})
    return out


def phase_moe(torch, card: str) -> dict:
    """qwen3-moe-30b-a3b at full width cut to ``MOE_SERVE_LAYERS`` of its
    48 layers of attention and a 128-expert top-8 MoE (untied unembedding;
    bf16 weights seeded on the card, leaf by leaf) alone on the card: ``serve_moe`` and ``lflr_moe`` through
    :func:`phase_serve` on the first ``MOE_REQUESTS`` requests and one with
    a ``SHORT_PROMPT``-token prompt (the KV fault in one MoE layer's attention
    cache, LFLR streams bit-equal to the clean run's; the short request's
    stream compared with the forward below its drop-free prefix: a
    63-token prompt, the shortest of the 6, may itself drop, at a mean load
    of 3.9 against a capacity of 8), gated first in fp32 at
    ``MOE_FP32_LAYERS`` layers (:func:`check_moe_fp32_stream`, before the
    full model is built), then ``engines_moe``: the stepwise and the
    blocking engine serve the short request's first ``ENGINE_NEW`` tokens,
    the first of ``serve_moe``'s stream token for token, with each engine's syncs and launches. The lines add
    the init's and each run's peak memory. Returns the launches by path."""
    from repro_torch.configs import get_config
    from repro_torch.serve import Request

    fp32 = check_moe_fp32_stream(torch, get_config(MOE_ARCH))
    torch.cuda.reset_peak_memory_stats()
    model, init_s = build_model(torch, get_config(MOE_ARCH).replace(
        num_layers=MOE_SERVE_LAYERS))
    cfg = model.cfg
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    paths, clean = phase_serve(torch, card, model, init_s, ("serve_moe", "lflr_moe"),
                               n=MOE_REQUESTS, short=1,
                               line={"init_peak_mem_gb": init_peak,
                                     "layers": f"{MOE_SERVE_LAYERS} of 48",
                                     "forward_check_fp32": fp32})
    rows = {}
    for name in ("stepwise", "blocking"):
        torch.cuda.reset_peak_memory_stats()
        reqs = [Request(id=r.id, prompt=r.prompt, max_new_tokens=ENGINE_NEW)
                for r in make_requests(cfg, Request, n=MOE_REQUESTS, short=1)[-1:]]
        run = serve_engine(torch, model, ENGINES[name], reqs)
        out, m = run["answers"], run["metrics"]
        if m.faults or streams(out) != {r.id: clean[r.id][:ENGINE_NEW] for r in reqs}:
            fail(f"engines_moe/{name}: faults {m.faults}, or streams differ from "
                 "serve_moe's")
        prefilled = sum(len(r.prompt) for r in reqs) if not run["overlap"] else 0
        if run["syncs"] > 2 * (m.windows or m.decode_steps) + 2 * m.prefills:
            fail(f"engines_moe/{name}: {run['syncs']} host syncs for {m.windows} "
                 f"windows, {m.decode_steps} steps and {m.prefills} prefills")
        slot_steps = m.decode_steps + prefilled
        expected = dict.fromkeys(run["launches"], 0)
        expected.update({"flash_attention": len(model.attn_layers) * slot_steps,
                         "flash_decode": len(model.attn_layers) * slot_steps,
                         "probe_rows": slot_steps})
        if run["launches"] != expected:
            fail(f"engines_moe/{name}: kernel launches {run['launches']} != {expected}")
        paths[f"engines_moe_{name}"] = run["launches"]
        rows[name] = {"config": ENGINES[name], "wall_s": run["wall"],
                      "steps": m.decode_steps, "prefills": m.prefills,
                      "host_stall_s": m.host_stall_s, "syncs": run["syncs"],
                      "launches": run["launches"],
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit({"phase": "engines_moe", "card": card, "model": cfg.name,
          "request": MOE_REQUESTS, "new_tokens": ENGINE_NEW,
          "streams_equal_serve_moe": True, **rows})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def probe_logits_row(torch, gen, V: int) -> dict:
    """The probe over serve's logits (slots, V) fp32 against its plain
    version (a NaN and an inf planted in two rows), its time and bound."""
    from repro_torch.core.errors import ErrorCode
    from repro_torch.kernels import probe_rows
    from repro_torch.kernels.fault_probe import probe_rows_ref

    f32 = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=gen, device="cuda", dtype=torch.float32)
    nf, ov = int(ErrorCode.NONFINITE_LOSS), int(ErrorCode.DIVERGENCE)
    x = f32(NUM_SLOTS, V)
    x[2, V - 1] = float("nan")
    x[5, 0] = float("-inf")
    got = probe_rows(x, math.inf, nonfinite_code=nf, overflow_code=ov)
    want = probe_rows_ref(x, math.inf, nonfinite_code=nf, overflow_code=ov)
    if not torch.equal(got, want) or got.tolist() != [0, 0, nf, 0, 0, nf, 0, 0]:
        fail(f"probe_rows over {NUM_SLOTS}x{V} logits wrong: {got.tolist()} vs "
             f"{want.tolist()}")
    xs = copies(lambda: (f32(NUM_SLOTS, V),), NUM_SLOTS * V * 4)
    b_ms, b_by = bound(NUM_SLOTS * V * 4 + NUM_SLOTS * 4, 3 * NUM_SLOTS * V, PEAK_FP32_FLOPS)
    row = {"shape": f"logits {NUM_SLOTS}x{V} fp32, threshold inf", "words": got.tolist(),
           "max_abs_err": (got - want).abs().max().item(), "timing_copies": len(xs),
           "kernel_ms": time_ms(torch, lambda x: probe_rows(
               x, math.inf, nonfinite_code=nf, overflow_code=ov), xs),
           "plain_ms": time_ms(torch, lambda x: probe_rows_ref(
               x, math.inf, nonfinite_code=nf, overflow_code=ov), xs),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    del x, xs
    return row


def probe_prefill_row(torch, gen, V: int) -> dict:
    """The probe over the prefill logits (PREFILL_B * PREFILL_S, V) fp32
    against its plain version (a NaN planted in the last row), its time and
    bound."""
    from repro_torch.core.errors import ErrorCode
    from repro_torch.kernels import probe_rows
    from repro_torch.kernels.fault_probe import probe_rows_ref

    f32 = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=gen, device="cuda", dtype=torch.float32)
    nf, ov = int(ErrorCode.NONFINITE_LOSS), int(ErrorCode.DIVERGENCE)
    rows = PREFILL_B * PREFILL_S
    x = f32(rows, V)
    x[rows - 1, V - 1] = float("nan")
    got = probe_rows(x, math.inf, nonfinite_code=nf, overflow_code=ov)
    want = probe_rows_ref(x, math.inf, nonfinite_code=nf, overflow_code=ov)
    err = (got - want).abs().max().item()
    if not torch.equal(got, want) or int(got.amax()) != nf or int(got[:-1].amax()) != 0:
        fail(f"probe_rows over {rows}x{V} prefill logits disagrees with its plain version")
    del x, got, want
    xs = copies(lambda: (f32(rows, V),), rows * V * 4)
    b_ms, b_by = bound(rows * V * 4 + rows * 4, 3 * rows * V, PEAK_FP32_FLOPS)
    row = {"shape": f"logits {rows}x{V} fp32, threshold inf", "max_abs_err": err,
           "timing_copies": len(xs),
           "kernel_ms": time_ms(torch, lambda x: probe_rows(
               x, math.inf, nonfinite_code=nf, overflow_code=ov), xs),
           "plain_ms": time_ms(torch, lambda x: probe_rows_ref(
               x, math.inf, nonfinite_code=nf, overflow_code=ov), xs, launches=8),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    del xs
    torch.cuda.empty_cache()
    return row


def phase_kernels_arch(torch, card: str) -> dict:
    """flash and the probe at the head layouts and vocabularies of
    starcoder2-3b, chatglm3-6b and phi3.5-moe-42b-a6.6b, which no earlier
    path launches: decode over starcoder2's 4096-entry ring (24/2 heads of
    128, group 12: the decode block's m16 tile three quarters full), wrapped
    past 4096; over chatglm3's full cache (32/2, group 16 = MAX_GROUP: the
    tile full) and phi3.5-moe's (32/8); the verify at 32/2, 8 slots x 4
    rows, also bit for bit against 4 decode launches at pos + t; the
    forward at 24/2 with the 4096 window binding over 2 x 8192 (rows packed
    s * 12 + head) and at 32/2 causal over 2 x 4096 (s * 16 + head); the
    probe over each model's serve logits. Each flash row with its controls,
    which must exceed the limit, and its times; the line adds the peak
    memory (the plain forward at 24 heads x 8192^2 fp32 scores is the
    largest: the phase runs with no model on the card)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention.ops import plan

    sc2, glm, phi = (get_config(a) for a in ARCH_SERVE)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    randn = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    D, out = 128, {}
    ring = sc2.sliding_window
    for name, cfg, cap, pos in (
            ("flash_sc2_ring_decode", sc2, ring,
             [0, 1, ring // 2 - 1, ring - 1, ring, ring + 904, 2 * ring - 1, 2 * ring + 808]),
            ("flash_glm_decode", glm, MAX_LEN, [0, 1, 100, 511, 700, 1022, MAX_LEN - 1, 1500]),
            ("flash_phi_decode", phi, MAX_LEN, [0, 5, 64, 300, 777, 1022, MAX_LEN - 1, 2000])):
        out[name] = flash_decode_row(torch, randn, name, cfg.num_heads, cfg.num_kv_heads,
                                     D, cap, pos)

    # -- the verify at chatglm3's 32/2: T rows per slot in one launch, rows
    #    at split and tile edges and past the capacity
    Hq, Hkv, B, T = glm.num_heads, glm.num_kv_heads, NUM_SLOTS, SPEC["draft_len"] + 1
    vpos = [0, 1, 61, 509, 700, MAX_LEN - T, MAX_LEN - 2, 1500]
    voff = torch.tensor(vpos, dtype=torch.int32, device=dev)
    kpos = torch.arange(MAX_LEN, device=dev)
    qp = voff[:, None] + torch.arange(T, device=dev)
    vmask = (kpos[None, None, :] <= qp[:, :, None])[:, None]
    edge = plan(1, MAX_LEN, Hkv, torch.bfloat16).keys_per_split
    vkw = {"causal": True, "seq_kv": MAX_LEN, "verify": True}

    def rows_bit_equal(q, k, v, got):
        rows = torch.cat([flash_attention(q[:, t:t + 1].contiguous(), k, v, voff + t,
                                          causal=True, seq_kv=MAX_LEN) for t in range(T)],
                         dim=1)
        if not torch.equal(got, rows):
            fail("flash_glm_verify: rows not bit-equal to decode launches at pos + t")
        return {"rows_bit_equal_decode": True}

    vctx = [min(p + T, MAX_LEN) for p in vpos]
    out["flash_glm_verify"] = flash_row(
        torch, randn, "flash_glm_verify",
        f"q {B}x{T}x{Hq}x{D}, kv {B}x{MAX_LEN}x{Hkv}x{D} bf16, pos {vpos}",
        (B, T, Hq, D), (B, MAX_LEN, Hkv, D), voff, vkw,
        {"one_key_dropped": lambda q, k, v: flash_attention(
            q, k, v, voff, causal=True, seq_kv=MAX_LEN - 1, verify=True),
         f"key_{edge}_doubled": lambda q, k, v: flash_attention(
            q, *key_doubled(k, v, edge), voff, causal=True, seq_kv=MAX_LEN, verify=True)},
        sum(vctx), sum(min(p + t + 1, MAX_LEN) for p in vpos for t in range(T)),
        {"attn_mask": vmask}, check=rows_bit_equal)
    if out["flash_glm_verify"]["kernel"] != "flash_verify":
        fail(f"flash_glm_verify took {out['flash_glm_verify']['kernel']}")

    # -- the forward: starcoder2's window binding over 2 x 8192 (24/2), and
    #    chatglm3's causal 2 x 4096 (32/2)
    for name, cfg, (Bp, Sp), win in (
            ("flash_sc2_sliding_forward", sc2, (PREFILL_B, 2 * ring), ring),
            ("flash_glm_forward", glm, (PREFILL_B, PREFILL_S), 0)):
        Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
        zero = torch.zeros(Bp, dtype=torch.int32, device=dev)
        qpos = torch.arange(Sp, device=dev)
        mask = qpos[None, :] <= qpos[:, None]
        if win:
            mask &= qpos[None, :] > qpos[:, None] - win
            control = {"window_one_short": lambda q, k, v, z=zero, w=win: flash_attention(
                q, k, v, z, causal=True, window=w - 1)}
        else:
            control = {"one_key_dropped": lambda q, k, v, z=zero, n=Sp: flash_attention(
                q, k, v, z, causal=True, seq_kv=n - 1)}
        out[name] = flash_row(
            torch, randn, name,
            f"q {Bp}x{Sp}x{Hq}x{D}, kv {Bp}x{Sp}x{Hkv}x{D} bf16, causal"
            + (f", window {win}" if win else ""),
            (Bp, Sp, Hq, D), (Bp, Sp, Hkv, D), zero, {"causal": True, "window": win},
            control, Bp * Sp, Bp * sum(min(s + 1, win or Sp) for s in range(Sp)),
            {"attn_mask": mask}, plain_launches=8)
        del mask
        torch.cuda.empty_cache()

    for name, cfg in (("probe_sc2_logits", sc2), ("probe_glm_logits", glm),
                      ("probe_phi_logits", phi)):
        out[name] = probe_logits_row(torch, gen, cfg.vocab_size)
    torch.cuda.empty_cache()
    emit({"phase": "kernels_arch", "card": card, **out,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return out


def phase_arch(torch, card: str, arch: str, tag: str, *, layers=None,
               short: int = 0) -> dict:
    """``serve_<tag>`` and ``lflr_<tag>`` (:func:`phase_serve`) for ``arch``
    at full width, seeded on the card alone (the model before it freed),
    on serve's first ``MOE_REQUESTS`` requests and ``short`` short-prompt
    ones, the fault in layer 0's K (a sliding layer's ring for starcoder2:
    its 1024 entries hold the whole row at ``MAX_LEN``). ``layers`` cuts the
    depth (never the width), and the lines say so. An MoE model's forward
    check is gated first in fp32 at ``MOE_FP32_LAYERS`` layers
    (:func:`check_moe_fp32_stream`), before the model is built. The lines
    add the init's peak memory. Frees the model; returns the launches by
    path."""
    from repro_torch.configs import get_config

    cfg, line = get_config(arch), {}
    if layers is not None:
        line["layers"] = f"{layers} of {cfg.num_layers}"
        cfg = cfg.replace(num_layers=layers)
    if cfg.is_moe:
        line["forward_check_fp32"] = check_moe_fp32_stream(torch, cfg)
    torch.cuda.reset_peak_memory_stats()
    model, init_s = build_model(torch, cfg)
    line["init_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    paths, _ = phase_serve(torch, card, model, init_s, (f"serve_{tag}", f"lflr_{tag}"),
                           poison_layers=[0], n=MOE_REQUESTS, short=short, line=line)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def phase_kernels_vlm(torch, card: str) -> dict:
    """flash and the probe at llama-3.2-vision-11b's and hubert-xlarge's
    shapes, which no earlier path launches, no model on the card: the cross
    decode (8 slots, 32/8 heads of 128, one query row over all 1601 image
    keys, no mask: four splits of 448 keys, the last tile ragged), the cross
    forward (2 x 4096 rows over 1601 keys, non-causal, T != S), hubert's
    bidirectional forward (2 x 4096, 16/16 heads of 80: MHA at head_dim 80),
    llama-vision's self-attention forward (2 x 4096, 32/8, causal: the
    prefill's) and decode (32/8, the 1024-entry cache), the
    probe over its 8 serve logit rows (vocab 128256) and over hubert's
    prefill logits (8192 x 504). Each flash row has controls that must
    exceed the limit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention.ops import plan

    vlm, hub = get_config(VLM_ARCH), get_config(HUBERT_ARCH)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    randn = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    out = {}
    T, Hq, Hkv, D = vlm.img_tokens, vlm.num_heads, vlm.num_kv_heads, vlm.resolved_head_dim
    B = NUM_SLOTS
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    edge = plan(1, T, Hkv, torch.bfloat16).keys_per_split
    out["flash_vlm_cross_decode"] = flash_row(
        torch, randn, "flash_vlm_cross_decode",
        f"q {B}x1x{Hq}x{D}, kv {B}x{T}x{Hkv}x{D} bf16, non-causal (cross)",
        (B, 1, Hq, D), (B, T, Hkv, D), zeros, {"causal": False},
        {"one_key_dropped": lambda q, k, v: flash_attention(
            q, k, v, zeros, causal=False, seq_kv=T - 1),
         f"key_{edge}_doubled": lambda q, k, v: flash_attention(
            q, *key_doubled(k, v, edge), zeros, causal=False)},
        B * T, B * T, {})
    if out["flash_vlm_cross_decode"]["kernel"] != "flash_decode":
        fail(f"flash_vlm_cross_decode took {out['flash_vlm_cross_decode']['kernel']}")
    out["flash_vlm_cross_decode"]["splits"] = plan(1, T, Hkv, torch.bfloat16).splits

    z2 = torch.zeros(PREFILL_B, dtype=torch.int32, device=dev)
    for name, cfg, kv_len in (("flash_vlm_cross_forward", vlm, T),
                              ("flash_hubert_forward", hub, PREFILL_S)):
        Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        out[name] = flash_row(
            torch, randn, name,
            f"q {PREFILL_B}x{PREFILL_S}x{Hq}x{D}, kv {PREFILL_B}x{kv_len}x{Hkv}x{D} bf16, "
            "non-causal",
            (PREFILL_B, PREFILL_S, Hq, D), (PREFILL_B, kv_len, Hkv, D), z2,
            {"causal": False},
            {"one_key_dropped": lambda q, k, v, n=kv_len: flash_attention(
                q, k, v, z2, causal=False, seq_kv=n - 1)},
            PREFILL_B * kv_len, PREFILL_B * PREFILL_S * kv_len, {}, plain_launches=8)
        if out[name]["kernel"] != "flash_forward":
            fail(f"{name} took {out[name]['kernel']}")
        torch.cuda.empty_cache()

    Hq, Hkv, D, S = vlm.num_heads, vlm.num_kv_heads, vlm.resolved_head_dim, PREFILL_S
    out["flash_vlm_forward"] = flash_row(
        torch, randn, "flash_vlm_forward",
        f"q {PREFILL_B}x{S}x{Hq}x{D}, kv {PREFILL_B}x{S}x{Hkv}x{D} bf16, causal",
        (PREFILL_B, S, Hq, D), (PREFILL_B, S, Hkv, D), z2, {"causal": True},
        {"one_key_dropped": lambda q, k, v: flash_attention(
            q, k, v, z2, causal=True, seq_kv=S - 1)},
        PREFILL_B * S, PREFILL_B * S * (S + 1) // 2, {"is_causal": True}, plain_launches=8)
    torch.cuda.empty_cache()
    out["flash_vlm_decode"] = flash_decode_row(
        torch, randn, "flash_vlm_decode", Hq, Hkv, D, MAX_LEN,
        [0, 3, 64, 447, 448, 1022, MAX_LEN - 1, 1800])
    out["probe_vlm_logits"] = probe_logits_row(torch, gen, vlm.vocab_size)
    out["probe_hubert_prefill"] = probe_prefill_row(torch, gen, hub.vocab_size)
    torch.cuda.empty_cache()
    emit({"phase": "kernels_vlm", "card": card, **out,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return out


def check_vlm_against_forward(torch, model) -> dict:
    """The cross layers over filled image K/V, which serving never gives
    them: every cross gate drawn non-zero from a seeded generator (the
    seeded model's are 0), ``VLM_ROWS`` rows of seeded image embeddings
    projected into each cross layer's cache through ``precompute_cross_kv``,
    ``VLM_PROMPT`` seeded prompt tokens fed a decode step at a time, then
    ``VLM_WINDOWS`` decode windows of ``WINDOW`` greedy steps; each row's
    stream is held against ``forward(tokens, img_embeds=...)``: every
    decoded token the forward's argmax or within ``FORWARD_GAP_TOL`` of it
    (bf16 decode and forward round differently over 40 layers), as the
    other forward checks. The forward without the images must give other
    logits (the images act). The gates stay drawn for the prefill phase;
    counts from 0 (the path's launches: flash decode at every layer, the
    self-attention and the cross layers alike, the probe at every window
    step, and the two forwards' flash launches and probes)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import make_decode_window, make_prefill_step
    from repro_torch.models.attention import precompute_cross_kv

    cfg, dev = model.cfg, model.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    cross = [blk for blk in model.blocks if blk.btype == "cross"]
    with torch.no_grad():
        for blk in cross:
            blk.gate_attn.normal_(generator=gen)
            blk.gate_mlp.normal_(generator=gen)
    gates = [round(float(torch.tanh(b.gate_attn)), 4) for b in cross]
    B, P = VLM_ROWS, VLM_PROMPT
    img = torch.randn((B, cfg.img_tokens, cfg.d_model), generator=gen, device=dev,
                      dtype=torch.float32).to(model.dtype)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev,
                           dtype=torch.int32)
    reset_launch_counts()
    t0 = time.perf_counter()
    cache = model.init_cache(B, MAX_LEN)
    for j, blk in enumerate(cross):
        cache["k_cross"][j], cache["v_cross"][j] = precompute_cross_kv(blk.attn, img, cfg)
    for p in range(P):
        logits = model.decode_step(prompt[:, p:p + 1], cache, p)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    pos = torch.full((B,), P, dtype=torch.int32, device=dev)
    window = make_decode_window(model, window=WINDOW)
    served = [tok]
    for _ in range(VLM_WINDOWS):
        toks, _, tok, pos = window(cache, tok, pos)
        served += list(toks)
    served = torch.stack(served, dim=1)                       # (B, N)
    seq = torch.cat([prompt, served[:, :-1]], dim=1).long()
    step = make_prefill_step(model)
    logits, word = step(seq, img_embeds=img)
    rows = logits[:, P - 1:]                                   # (B, N, V)
    no_img, _ = step(seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if int(word) != 0 or not bool(torch.isfinite(rows).all()):
        fail(f"forward_check_vlm: the forward's logits are not finite (word {int(word)})")
    gap = rows.max(dim=-1).values - rows.gather(2, served.long()[..., None])[..., 0]
    worst = float(gap.max())
    if worst > FORWARD_GAP_TOL:
        fail(f"forward_check_vlm: decode over the image K/V disagrees with the "
             f"forward (largest logit gap {worst})")
    moved = float((no_img[:, P - 1:] - rows).abs().max())
    if not moved > 0:
        fail("forward_check_vlm: the forward without the images gives the same logits")
    expected = dict.fromkeys(launches, 0)
    steps = P + VLM_WINDOWS * WINDOW
    layers, n_cross = len(model.attn_layers), len(cross)
    expected.update({"flash_attention": layers * steps + 2 * layers,
                     "flash_decode": layers * steps, "flash_forward": 2 * layers,
                     "probe_rows": VLM_WINDOWS * WINDOW + 2})
    if launches != expected:
        fail(f"forward_check_vlm: kernel launches {launches} != {expected}")
    del cache, logits, no_img, rows
    torch.cuda.empty_cache()
    return {"rows": B, "prompt": P, "decoded": int(served.shape[1]),
            "argmax_agree": int((gap == 0).sum()), "positions": int(gap.numel()),
            "max_gap": worst, "tol": FORWARD_GAP_TOL, "tanh_gate_attn": gates,
            "cross_decode_launches": n_cross * steps,
            "no_img_max_logit_diff": moved, "wall_s": wall, "launches": launches}


def phase_vlm(torch, card: str) -> dict:
    """Full-width llama-3.2-vision-11b (40 layers: 32 self-attention, 8
    cross; 19.55 GB of bf16 weights seeded on the card, alone on it, the
    model before it freed): ``serve_vlm`` and ``lflr_vlm`` through
    :func:`phase_serve` on serve's first ``MOE_REQUESTS`` requests, no image
    input (the JAX replica has none: every cross layer reads the zeros of a
    fresh cache and adds ``0 * tanh(0)``), the fault in layer 0's K, LFLR's
    streams bit-equal to the clean run's, flash decode 40 a step (8 over the
    image keys); ``forward_check_vlm`` (:func:`check_vlm_against_forward`);
    ``prefill_vlm``: the prefill step with 2 x 1601 image embeddings beside
    its 2 x 4096 tokens, and its NaN gate in batch row 0's image. Frees the
    model; returns the launches by path."""
    import numpy as np
    from repro_torch.configs import get_config

    cfg = get_config(VLM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    model, init_s = build_model(torch, cfg)
    n_cross = cfg.pattern_layers.count("cross")
    line = {"init_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "cross_layers": n_cross, "img_tokens": cfg.img_tokens,
            "cross_decode_per_step": n_cross,
            "cross_kv_gb": 2 * n_cross * NUM_SLOTS * cfg.img_tokens * cfg.num_kv_heads
            * cfg.resolved_head_dim * 2 / 1e9}
    paths, _ = phase_serve(torch, card, model, init_s, ("serve_vlm", "lflr_vlm"),
                           poison_layers=[0], n=MOE_REQUESTS, line=line)
    fwd = check_vlm_against_forward(torch, model)
    paths["forward_check_vlm"] = fwd.pop("launches")
    emit({"phase": "forward_check_vlm", "card": card, "model": cfg.name,
          "launches": paths["forward_check_vlm"], **fwd})
    rng = np.random.default_rng(SEED + 15)
    img = torch.from_numpy(rng.standard_normal(
        (PREFILL_B, cfg.img_tokens, cfg.d_model), dtype=np.float32)).to(
            device=model.device, dtype=model.dtype)
    paths["prefill_vlm"] = phase_prefill(torch, card, model, "prefill_vlm",
                                         {"img_embeds": img}, poison="img_embeds")
    del model, img
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def phase_hubert(torch, card: str) -> dict:
    """``prefill_hubert``: full-width hubert-xlarge (48 layers, d_model 1280,
    16/16 heads of 80, LayerNorm, plain GeLU, no rotary; 1.89 GB of bf16
    weights, alone on the card) through the prefill step from 2 x 4096
    seeded frame embeddings (its audio frontend is a stub, as in the JAX
    package): flash forward 48 times, non-causal at head_dim 80, one probe;
    a NaN in one frame of batch row 0 must make every logit row of that
    batch row non-finite (the attention is bidirectional) and leave batch
    row 1's finite. An encoder has no decode: no serve phase. Frees the
    model; returns the launches by path."""
    import numpy as np
    from repro_torch.configs import get_config

    model, _ = build_model(torch, get_config(HUBERT_ARCH))
    rng = np.random.default_rng(SEED + 16)
    frames = torch.from_numpy(rng.standard_normal(
        (PREFILL_B, PREFILL_S, model.cfg.d_model), dtype=np.float32)).to(
            device=model.device, dtype=model.dtype)
    paths = {"prefill_hubert": phase_prefill(
        torch, card, model, "prefill_hubert", {"inputs_embeds": frames},
        poison="inputs_embeds")}
    del model, frames
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def activation_cost(torch, model):
    """The MLP activation at the prefill shape (B, S, d_ff) in the model
    dtype, spelled op for op as the JAX package rounds it (the model's), and
    as one fused PyTorch call: ms per layer and over the model's MLP layers.
    None for a model without MLPs."""
    import torch.nn.functional as F
    from repro_torch.models.layers import gelu_tanh, silu
    from repro_torch.models.transformer import MLP
    cfg = model.cfg
    layers = sum(isinstance(m, MLP) for m in model.modules())
    if not layers:
        return None
    if cfg.mlp_kind == "swiglu":
        ours, fused = silu, F.silu
    else:
        ours, fused = gelu_tanh, lambda x: F.gelu(x, approximate="tanh")
    gen = torch.Generator(device=model.device).manual_seed(SEED + 5)
    shape = (PREFILL_B, PREFILL_S, cfg.d_ff)
    xs = copies(lambda: (torch.randn(shape, generator=gen, device=model.device,
                                     dtype=model.dtype),), math.prod(shape) * 2)
    op_ms, fused_ms = time_ms(torch, ours, xs, launches=8), time_ms(torch, fused, xs, launches=8)
    return {"kind": cfg.mlp_kind, "shape": list(shape), "layers": layers,
            "op_for_op_ms": op_ms, "fused_ms": fused_ms,
            "extra_ms_per_call": layers * (op_ms - fused_ms)}


def kernel_entry(name: str, source: str, replaces: str, launches: dict,
                 primary: dict, shapes: dict, **extra) -> dict:
    """One kernel's row of the kernels line: launches summed over the main
    paths (and by path), times from its ``primary`` shape, the largest
    error over every shape it was held at, and every shape's numbers (with
    the kernel it went through, where the wrapper has several)."""
    keys = ("kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    row_keys = keys + ("max_abs_err", "shape", "kernel", "source")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "launches_by_path": launches,
            "ms": primary["kernel_ms"],
            "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
            **{k: primary[k] for k in keys[1:]}, **extra,
            "by_shape": {n: {k: v[k] for k in row_keys if k in v}
                         for n, v in shapes.items()}}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, src)
    card = phase_device(torch)
    phase_build()
    from repro_torch.configs import get_config

    # the deep train phases' steps, counted on fake tensors beside the card
    dryruns = start_dryruns([("train_rg", "recurrentgemma-2b", TRAIN_RG_LAYERS),
                             ("train_ssm", "mamba2-2.7b", TRAIN_SSM_LAYERS)])
    levers = {"microbatch": TRAIN_MICROBATCH, "ce_chunk": TRAIN_CE_CHUNK}

    kern = phase_kernels(torch, card)
    model, init_s = build_model(torch, get_config("qwen3-1.7b"))
    # the first 10 requests only (cut from 16 when the train phase came, for
    # the run's time; two freed slots still refilled, and every later qwen3
    # phase serves at most these 10)
    serve_paths, serve_streams = phase_serve(torch, card, model, init_s, traced=True,
                                             n=REFILL_REQUESTS, sync_sites=True)
    engines = phase_engines(torch, card, model)
    for name, engine in (("lflr_stepwise", "stepwise"), ("lflr_blocking", "blocking")):
        phase_lflr_engine(torch, card, model, name, ENGINES[engine],
                          engines["streams"][engine])
    # the first 6 requests only (cut from 16 to 10 when the traced and fuzz
    # phases came, and to 6 when the LayerNorm architectures' phases came,
    # for the run's time: the first 6 drop the 225- and 254-token prompts;
    # serve keeps the refilled slots)
    serve_paged, _ = phase_serve(
        torch, card, model, init_s, ("serve_paged", "lflr_paged"), paged=True,
        n=MOE_REQUESTS, want={i: serve_streams[i] for i in range(MOE_REQUESTS)})
    # the first 8 requests only (cut when the speculative phases came, to
    # keep the run's time): page_fault still corrupts a decoding lane, and
    # 8 lanes still outgrow the 64-page pool; held to serve's streams
    # (serve_paged holds paged to contiguous on its 6)
    phase_page_fault(torch, card, model, serve_streams)
    phase_paged_pressure(torch, card, model, serve_streams)
    engines_paged = phase_engines_paged(torch, card, model,
                                        engines["streams"]["blocking"])
    spec_paths = phase_spec(torch, card, model, init_s, serve_streams)
    group_paths = phase_group(torch, card, model, serve_streams)
    fuzz_paths = phase_fuzz(torch, card, model)
    multihost_paths = phase_multihost(torch, card, model.cfg, serve_streams)
    phase_elastic(torch, card)
    kern_train, train_launches = phase_train(torch, card, model)
    del model                                     # free qwen3 before rg
    gc.collect()
    torch.cuda.empty_cache()

    kern_rg = phase_kernels_rg(torch, card)
    model, init_s = build_model(torch, get_config("recurrentgemma-2b"))
    # the first 6 requests only (cut from 16 to 10 when the traced and fuzz
    # phases came, and to 6 when the LayerNorm architectures' phases came,
    # for the run's time: the first 6 drop the 225- and 254-token prompts,
    # 208 steps against 318; a freed recurrent slot's reset is held by the
    # CPU tests' reused-slot case)
    serve_rg, _ = phase_serve(torch, card, model, init_s, ("serve_rg", "lflr_rg"),
                              n=MOE_REQUESTS)
    phase_lflr_stepwise_rg(torch, card, model)
    prefill_rg = phase_prefill(torch, card, model, "prefill_rg")
    del model                                     # free rg before its training
    kern_levers, train_levers = phase_train_levers(torch, card)
    kern_train_rg, train_rg = phase_train_cut(
        torch, card, "recurrentgemma-2b", "train_rg", TRAIN_RG_LAYERS, levers=levers,
        dryrun=lambda: dryruns("train_rg"))

    kern_ssm = phase_kernels_ssm(torch, card)
    model, init_s = build_model(torch, get_config("mamba2-2.7b").replace(
        num_layers=SSM_SERVE_LAYERS))
    # the first 6 requests only (cut from 8, one per slot, when the MoE
    # phases came, for the run's time: the first 6 drop the 225- and
    # 254-token prompts, 200 steps against 318)
    serve_ssm, _ = phase_serve(torch, card, model, init_s, ("serve_ssm", "lflr_ssm"),
                               n=MOE_REQUESTS,
                               line={"layers": f"{SSM_SERVE_LAYERS} of 64"})
    prefill_ssm = phase_prefill(torch, card, model, "prefill_ssm")
    del model                                     # free mamba2 before its training
    kern_train_ssm, train_ssm = phase_train_cut(
        torch, card, "mamba2-2.7b", "train_ssm", TRAIN_SSM_LAYERS, levers=levers,
        dryrun=lambda: dryruns("train_ssm"))

    kern_g3 = phase_kernels_g3(torch, card)
    model, init_s = build_model(torch, get_config("gemma3-1b"))
    # the fault: K of layer 5, the first full layer (max_len > the window);
    # the first 10 requests only (cut from 16 when the train phase came, for
    # the run's time: 79 windows against 93; the two long prompts among
    # them, two slots refilled)
    serve_g3, g3_streams = phase_serve(torch, card, model, init_s,
                                       ("serve_g3", "lflr_g3"), long=2,
                                       poison_layers=[5], n=REFILL_REQUESTS,
                                       sync_sites=True)
    # the same through the pool, on the first 8 requests (the two long
    # prompts among them; cut when the speculative phases came, to keep the
    # run's time): the 4 full layers paged, the rings dense; the fault goes
    # into K of layer 5, now a pool page
    serve_g3_paged, _ = phase_serve(
        torch, card, model, init_s, ("serve_g3_paged", "lflr_g3_paged"), long=2,
        poison_layers=[5], paged=True, n=NUM_SLOTS,
        want={i: g3_streams[i] for i in range(NUM_SLOTS)})
    prefill_g3 = phase_prefill(torch, card, model, "prefill_g3")
    del model                                     # free gemma3 before the MoE
    gc.collect()
    torch.cuda.empty_cache()

    kern_moe = phase_kernels_moe(torch, card)
    moe_paths = phase_moe(torch, card)
    kern_arch = phase_kernels_arch(torch, card)
    for arch, tag, kw in zip(ARCH_SERVE, ("sc2", "glm", "phi"),
                             ({}, {"short": 1}, {"short": 1, "layers": PHI_LAYERS})):
        moe_paths.update(phase_arch(torch, card, arch, tag, **kw))
    kern_vlm = phase_kernels_vlm(torch, card)
    moe_paths.update(phase_vlm(torch, card))
    moe_paths.update(phase_hubert(torch, card))
    kern_train_hubert, train_hubert = phase_train_cut(
        torch, card, HUBERT_ARCH, "train_hubert", get_config(HUBERT_ARCH).num_layers)
    kern_train_vlm, train_vlm = phase_train_cut(torch, card, VLM_ARCH, "train_vlm",
                                                TRAIN_VLM_LAYERS)
    emit({"phase": "run", "seconds": time.perf_counter() - START})
    paths = {**serve_paths,
             **{f"engines_{e}": c for e, c in engines["launches"].items()},
             **serve_paged, "engines_paged": engines_paged,
             **spec_paths, **group_paths, **fuzz_paths, **multihost_paths,
             "train": train_launches,
             **serve_g3_paged,
             **serve_rg, "prefill_rg": prefill_rg, "train_levers": train_levers,
             "train_rg": train_rg,
             **serve_ssm, "prefill_ssm": prefill_ssm, "train_ssm": train_ssm,
             **serve_g3, "prefill_g3": prefill_g3, **moe_paths,
             "train_hubert": train_hubert, "train_vlm": train_vlm}
    by_path = lambda k: {p: c[k] for p, c in paths.items()}  # noqa: E731
    emit({"kernels": [
        kernel_entry(
            "flash_attention", kern["flash_decode"]["source"],
            "src/repro/kernels/flash_attention/kernel.py:81",
            by_path("flash_attention"), kern["flash_decode"],
            {"flash_decode": kern["flash_decode"],
             "flash_verify": kern["flash_verify"],
             "flash_forward": kern["flash_forward"],
             "flash_train_forward": kern_train["flash_train_forward"],
             "flash_train_forward_levers": kern_levers["flash_train_forward"],
             "flash_train_forward_rg": kern_train_rg["flash_train_forward"],
             "flash_train_forward_hubert": kern_train_hubert["flash_train_forward"],
             "flash_train_forward_vlm": kern_train_vlm["flash_train_forward"],
             "flash_train_forward_vlm_cross": kern_train_vlm["flash_train_forward_cross"],
             "flash_f32_decode": kern["flash_f32_decode"],
             "flash_f32_forward": kern["flash_f32_forward"],
             "flash_ring_decode": kern_rg["flash_ring_decode"],
             "flash_sliding_forward": kern_rg["flash_sliding_forward"],
             **{n: kern_g3[n] for n in ("flash_g3_decode", "flash_g3_ring_decode",
                                        "flash_g3_sliding_forward", "flash_g3_forward")},
             "flash_moe_decode": kern_moe["flash_moe_decode"],
             **{n: r for n, r in kern_arch.items() if n.startswith("flash_")},
             **{n: r for n, r in kern_vlm.items() if n.startswith("flash_")}},
            launches_by_kernel={k: by_path(k) for k in (
                "flash_decode", "flash_verify", "flash_forward", "flash_f32")}),
        kernel_entry(
            "probe_rows", "src/repro_torch/kernels/fault_probe/csrc/fault_probe.cu",
            "src/repro/kernels/fault_probe/kernel.py:44",
            {p: c["probe_rows"] + c["probe_tree"] for p, c in paths.items()},
            kern["probe_rows"],
            {"probe_rows": kern["probe_rows"], "probe_verify": kern["probe_verify"],
             "probe_state": kern_rg["probe_state"],
             "probe_prefill": kern_rg["probe_prefill"],
             "probe_ssm": kern_ssm["probe_ssm"],
             "probe_g3_logits": kern_g3["probe_g3_logits"],
             "probe_g3_prefill": kern_g3["probe_g3_prefill"],
             "probe_grad_embed": kern_train["probe_grad_embed"],
             "probe_grad_tree": kern_train["probe_grad_tree"],
             **{f"{n}_{tag}": k[n] for tag, k in (("rg", kern_train_rg),
                                                  ("ssm", kern_train_ssm),
                                                  ("hubert", kern_train_hubert),
                                                  ("vlm", kern_train_vlm))
                for n in ("probe_grad_embed", "probe_grad_tree")},
             **{n: r for n, r in kern_arch.items() if n.startswith("probe_")},
             **{n: r for n, r in kern_vlm.items() if n.startswith("probe_")}},
            launches_by_kernel={k: by_path(k) for k in ("probe_rows", "probe_tree")}),
        # the scans' rows also hold their backward kernels (the gradient
        # through the TPU kernel, which has no backward of its own)
        kernel_entry(
            "rglru_scan", "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
            "src/repro/kernels/rglru_scan/kernel.py:36",
            {p: c["rglru_scan"] + c["rglru_scan_bwd"] for p, c in paths.items()},
            kern_rg["rglru_scan"],
            {n: kern_rg[n] for n in ("rglru_scan", "rglru_scan_long_memory",
                                     "rglru_scan_train", "rglru_scan_microbatch",
                                     "rglru_scan_bwd", "rglru_scan_bwd_train",
                                     "rglru_scan_bwd_microbatch",
                                     "rglru_scan_bwd_long_memory")},
            launches_by_kernel={k: by_path(k) for k in ("rglru_scan", "rglru_scan_bwd")}),
        kernel_entry(
            "ssd_scan", kern_ssm["ssd_scan"]["source"],
            "src/repro/kernels/ssd_scan/kernel.py:47",
            {p: c["ssd_scan"] + c["ssd_chunk_bwd"] for p, c in paths.items()},
            kern_ssm["ssd_scan"],
            {"ssd_scan": kern_ssm["ssd_scan"],
             "ssd_scan_groups": kern_ssm["ssd_scan_groups"],
             "ssd_scan_train": kern_ssm["ssd_scan_train"],
             "ssd_scan_microbatch": kern_ssm["ssd_scan_microbatch"],
             "ssd_f32": kern_ssm["ssd_f32"],
             "ssd_chunk_bwd": kern_ssm["ssd_chunk_bwd"],
             "ssd_chunk_bwd_train": kern_ssm["ssd_chunk_bwd_train"],
             "ssd_chunk_bwd_microbatch": kern_ssm["ssd_chunk_bwd_microbatch"],
             "ssd_chunk_bwd_f32": kern_ssm["ssd_chunk_bwd_f32"]},
            launches_by_kernel={k: by_path(k) for k in (
                "ssd_chunk_tc", "ssd_f32", "ssd_chunk_bwd", "ssd_chunk_bwd_tc",
                "ssd_chunk_bwd_f32")}),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
