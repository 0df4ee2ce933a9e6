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
   kernel of the tensor-core and scan sources (``PTXAS_SOURCES``);
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
   prefill step's forward;
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
   the first 10 requests (cut from 16 when the traced and fuzz phases came,
   for the run's time; two freed slots are still refilled);
9. page_fault — the same run, on the first 8 requests, with one decoding
   lane's page-table row unmapped mid-run: PAGE_FAULT raised at the wait on
   that slot, one ``page_reclaim`` record, every stream equal to phase 8's;
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
   its own; no fault record carries DRAFT_REJECT; serve_spec_paged runs the
   first 8 requests (cut when the group phases came), serve_spec and
   lflr_spec the first 10 (cut from 16 when the traced and fuzz phases came,
   for the run's time; two freed slots are still refilled);
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
11e. train — on the qwen3 model still loaded (after the fuzz phase): the
   train path's kernels at its shapes first — the flash forward with its
   row lse at B 4 x S 256 (16/8 heads, D 128, causal) against the plain
   lse (a control with one key dropped must exceed the limit) and bit-equal
   in its output to the launch without lse, FlashAttention's dq/dk/dv
   against autograd through the plain version in fp32 (a control against
   the mask shifted by one key must exceed the limit), the probe over the
   151936 x 2048 bf16 embedding gradient — each timed. Then three runs of
   12 steps of ``ResilientExecutor`` over ``make_train_step`` at B 4 x S
   256, each from a fresh copy of the serving model's weights with zero
   moments (the model itself unchanged), a snapshot every 5 steps, no
   checkpointer: clean — every step ok, exactly one host sync a step (the
   port's counter and torch's sync debug mode), ``flash_forward`` 28
   launches a step and ``probe_rows`` one per gradient leaf, finite losses;
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
   where a control in chunk 0 must exceed it after chunk 1; flash decode
   over ring caches that wrap, the sliding-window flash forward at S 4096,
   the probe over the recurrent state and over the prefill logits;
13. serve_rg   — phase 4 for full-width recurrentgemma-2b (26 layers: 18
   RG-LRU, 8 sliding-window attention; bf16, seeded random weights), the
   qwen3 model freed first, on the first 10 requests (cut from 16 when the
   traced and fuzz phases came, for the run's time; two freed recurrent
   slots are still refilled);
14. lflr_rg   — phase 5 for recurrentgemma-2b, on the same 10 requests: the
   NaN goes into the slots' recurrent state and the state probe must latch
   STATE_FAULT;
15. lflr_stepwise_rg — recurrentgemma's stepwise engine, 4 requests, clean
   and with a NaN in ``h``: the re-prefill rebuilds the lane across the
   state's (batch, layer) layout, and the streams are bit-equal;
16. prefill_rg — ``make_prefill_step`` at B 2, S 4096 (twice the sliding
   window): the scan kernel once per RG-LRU layer, flash once per sliding
   layer, one probe, a clean word, its time and peak memory;
17. kernels_ssm — the SSD intra-chunk kernel and the whole scan at
   mamba2-2.7b's prefill shape and at a shape with groups over heads and
   fewer steps than the chunk (bf16: the tensor-core route), and at the
   prefill shape in fp32 (the ``ssd_f32`` route), each with a control that
   must exceed the limit (one step's dt changed), and the probe over the
   full ``ssm`` state;
18. serve_ssm  — phase 4 for full-width mamba2-2.7b (64 SSD layers, bf16,
   seeded random weights), the recurrentgemma model freed first, on the
   first 8 of the 16 requests (one per slot: cut when the paged phases
   came, to keep the run's time);
19. lflr_ssm   — phase 5 for mamba2-2.7b: the NaN goes into the slots'
   ``ssm`` state and the state probe must latch STATE_FAULT;
20. prefill_ssm — ``make_prefill_step`` at B 2, S 4096: the SSD tensor-core
   kernel once per layer, one probe, a clean word, its time and peak memory;
21. kernels_g3 — flash and the probe at gemma3-1b's shapes (4/1 heads of
   256): decode over the full cache and over the 512-entry ring, wrapped,
   the sliding (window 512) and the full forward at 2 × 4096, the probe
   over 8 × 262144 logits, each flash row with controls;
22. serve_g3   — phase 4 for full-width gemma3-1b (26 layers: 22 sliding,
   4 full; bf16, seeded random weights), the mamba2 model freed first, on
   the first 10 requests (cut from 16 when the train phase came; two slots
   refilled); two of the prompts have 560 tokens, so the rings wrap, and
   the longest answer is held against the forward;
23. lflr_g3    — phase 5 for gemma3-1b: the NaN goes into K of layer 5, its
   first full layer, as in the JAX replica;
24. serve_g3_paged, lflr_g3_paged — phases 22 and 23 through the pool, on
   the first 8 requests: the 4 full layers paged, the 512-entry rings
   dense; the streams must equal phase 22's, and the NaN goes into K of
   layer 5, now a pool page;
25. prefill_g3 — ``make_prefill_step`` at B 2, S 4096: flash forward once per
   layer, one probe.

Then the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Any failure exits non-zero before the last line is printed.
"""
import gc
import json
import math
import os
import subprocess
import sys
import time
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
# the cut serve phases (paged, speculative, recurrentgemma): two requests
# more than the slots, so that two freed slots are refilled
REFILL_REQUESTS = NUM_SLOTS + 2
LONG_PROMPT = 560                   # gemma3: past its 512-entry rings
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


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - START}
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
                 "rglru_scan.cu")                        # reported by ptxas


def ptxas_report(log: str) -> list:
    """Each kernel instantiation in an ``nvcc -Xptxas -v`` log: its name and
    head_dim (flash's template argument; for flash_decode also whether it is
    the verify's instantiation), registers, static shared memory,
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


def make_requests(cfg, Request, long: int = 0, n: int = NUM_REQUESTS):
    """The serve phases' traffic, its first ``n`` requests; the first
    ``long`` requests get prompts of ``LONG_PROMPT`` tokens instead (drawn
    apart, so the others do not change)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 257)))
               for _ in range(NUM_REQUESTS)]
    rng_long = np.random.default_rng(SEED + 7)
    for i in range(long):
        prompts[i] = rng_long.integers(0, cfg.vocab_size, LONG_PROMPT)
    return [Request(id=i, prompt=tuple(int(t) for t in p), max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts[:n])]


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


def build_model(torch, cfg):
    from repro_torch.models import Model
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def phase_serve(torch, card: str, model, init_s: float, names=("serve", "lflr"),
                long: int = 0, poison_layers=None, paged: bool = False,
                want=None, n: int = NUM_REQUESTS, spec=None, traced: bool = False):
    """The serve phases (qwen3, recurrentgemma, mamba2, gemma3): serve the
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
    the same call. ``n`` cuts the traffic to its first requests. ``traced``
    serves the faulted traffic a second time, through a fresh replica with
    a ``Tracer``, holds it to the untraced faulted run and its trace to
    :func:`check_lflr_trace`. Returns the kernel launches by path (the
    clean run's under ``names[0]``, the traced run's under ``names[1]``)
    and the clean streams."""
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
    t0 = time.perf_counter()
    clean, _ = drive(rep, make_requests(cfg, Request, long, n))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    syncs = readback.count
    peak = torch.cuda.max_memory_allocated() / 1e9   # before the checks' own
    m = rep.metrics
    bad = [r.id for r in clean.values() if not r.ok or len(r.tokens) != MAX_NEW]
    if len(clean) != n or bad:
        fail(f"{names[0]}: {len(clean)} answers, not OK or short: {bad}")
    steps = WINDOW * m.windows
    recurrent = model.state_leaf is not None
    # per window step: flash once per attention layer, through the decode
    # kernel; the probe over the logits, and over the recurrent state where
    # there is one; no scan. Speculating: spec_launches
    expected = dict.fromkeys(launches, 0)
    if spec:
        expected.update(spec_launches(model, spec, steps))
    else:
        expected.update({"flash_attention": len(model.attn_layers) * steps,
                         "flash_decode": len(model.attn_layers) * steps,
                         "probe_rows": (2 if recurrent else 1) * steps})
    if launches != expected:
        fail(f"{names[0]}: kernel launches {launches} != {expected} "
             f"({len(model.attn_layers)} attention layers, "
             f"{'2 probes' if recurrent else '1 probe'} x {steps} window steps)")
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
    reqs = make_requests(cfg, Request, long, n)
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
          "peak_mem_gb": peak, "forward_check": forward, **pool, **drafts})
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
        reset_launch_counts()
        readback.count = 0
        t0 = time.perf_counter()
        answers, injected = drive(rep, make_requests(cfg, Request, long, n), inject)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return dict(answers=answers, injected=injected, state=state, wall=wall,
                    syncs=readback.count, launches=launch_counts(), m=rep.metrics,
                    ms_per_step=wall / (WINDOW * rep.metrics.windows) * 1e3)

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
    code = ErrorCode.STATE_FAULT if recurrent else ErrorCode.NONFINITE_LOSS
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
    paths = {names[0]: launches}
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
          "streams_bit_equal": True, "wall_s": lflr_wall})
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
    and every stream equals serve_paged's (``want``)."""
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
    # the first 10 requests only (cut from 16 when the traced and fuzz phases
    # came, for the run's time: two freed slots still refilled)
    paths, _ = phase_serve(
        torch, card, model, init_s, ("serve_spec", "lflr_spec"), spec=SPEC,
        n=REFILL_REQUESTS, want={i: want[i] for i in range(REFILL_REQUESTS)})
    # the first 8 requests only (cut when the group phases came, to keep the
    # run's time)
    paths.update(phase_serve(
        torch, card, model, init_s, ("serve_spec_paged", None), paged=True,
        spec=SPEC, n=NUM_SLOTS, want={i: want[i] for i in range(NUM_SLOTS)})[0])
    paths["serve_spec_deep"] = phase_spec_deep(torch, card, model)
    if not any(SERVE_LINES[p]["accepted"] and SERVE_LINES[p]["rejected"]
               for p in paths):
        fail(f"speculative phases: no phase both accepted and rejected a draft: "
             f"{ {p: SERVE_LINES[p] for p in paths} }")
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


def train_kernels(torch, cfg) -> dict:
    """The train path's kernels at its shapes (``cfg``'s heads, B x S =
    ``TRAIN_B x TRAIN_S``): the flash forward with its row lse
    (``flash_forward``) against the plain lse and its own output without
    lse, FlashAttention's gradients against autograd through the plain
    version, and the probe over the largest gradient leaf (the vocab x
    d_model embedding, 151936 x 2048 in bf16 for qwen3); each timed beside
    its bound, its plain version and the library call."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.core.errors import ErrorCode
    from repro_torch.kernels import flash_attention, probe_rows
    from repro_torch.kernels.fault_probe import probe_rows_ref
    from repro_torch.kernels.flash_attention import FlashAttention, sdpa_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 7)
    randn = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
    out = {}
    B, S = TRAIN_B, TRAIN_S
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = randn(B, S, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    before = dict(flash_attention.kernel_launches)
    got, lse = flash_attention(q, k, v, zero, causal=True, lse=True)
    moved = [n for n, c in flash_attention.kernel_launches.items() if c != before[n]]
    want, want_lse = sdpa_ref(q, k, v, q_offset=zero, causal=True, return_lse=True)
    a, r = LSE_TOL
    lse_excess = ((lse - want_lse).abs() / (a + r * want_lse.abs())).max().item()
    _, short_lse = sdpa_ref(q, k, v, q_offset=zero, causal=True, seq_kv=S - 1,
                            return_lse=True)
    lse_control = ((lse - short_lse).abs() / (a + r * short_lse.abs())).max().item()
    same_out = torch.equal(got, flash_attention(q, k, v, zero, causal=True))
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
    grads = torch.autograd.grad(FlashAttention.apply(*leaves, True, 0, 2048, 2048),
                                leaves, do)
    ga, gr = TRAIN_GRAD_TOL

    def grad_excess(offset):
        f = [t.float().requires_grad_() for t in (q, k, v)]
        ref = torch.autograd.grad(sdpa_ref(*f, q_offset=offset, causal=True), f,
                                  do.float())
        return [((g.float() - w).abs() / (ga * w.abs().max() + gr * w.abs())).max().item()
                for g, w in zip(grads, ref)]

    g_excess, g_control = grad_excess(zero), grad_excess(zero + 1)
    if not (max(g_excess) <= 1 < min(g_control)):
        fail(f"FlashAttention gradients dq, dk, dv: {g_excess} x the limit; "
             f"against the shifted mask {g_control} (each must exceed 1)")
    nbytes = 2 * B * S * Hq * D * 2 + 2 * B * S * Hkv * D * 2 + B * S * Hq * 4 + 4 * B
    flops = 4 * Hq * D * B * S * (S + 1) // 2
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    qkv = copies(lambda: (randn(B, S, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)),
                 B * S * (Hq + 2 * Hkv) * D * 2)
    heads_first = lambda *ts: tuple(t.transpose(1, 2) for t in ts)  # noqa: E731
    out["flash_train_forward"] = {
        "shape": f"q {B}x{S}x{Hq}x{D}, kv {B}x{S}x{Hkv}x{D} bf16, causal, with lse",
        "kernel": "flash_forward", "source": f"{FLASH_CSRC}/flash_forward.cu",
        "max_abs_err": err, "tol": FLASH_TOL, "err_over_tol": excess,
        "lse_max_abs_err": (lse - want_lse).abs().max().item(),
        "lse_tol": f"{LSE_TOL[0]} abs + {LSE_TOL[1]} rel",
        "lse_over_tol": lse_excess, "lse_one_key_dropped_over_tol": lse_control,
        "out_equal_without_lse": same_out,
        "grad_tol": f"{ga} x max + {gr} rel", "grad_over_tol": g_excess,
        "grad_shifted_mask_over_tol": g_control, "timing_copies": len(qkv),
        "kernel_ms": time_ms(torch, lambda q, k, v: flash_attention(
            q, k, v, zero, causal=True, lse=True), qkv),
        # one call per copy: ~40 launches a call, and the device queues
        # about 1000
        "plain_ms": time_ms(torch, lambda q, k, v: sdpa_ref(
            q, k, v, q_offset=zero, causal=True, return_lse=True), qkv,
            launches=len(qkv)),
        "library_ms": time_ms(torch, lambda *t: F.scaled_dot_product_attention(
            *t, is_causal=True, enable_gqa=True), [heads_first(*t) for t in qkv]),
        "bound_ms": b_ms, "bound_by": b_by}
    del q, k, v, do, leaves, grads, qkv

    # the probe over the largest gradient leaf, the tied embedding's (drawn
    # on the card: 311 M numbers from numpy would take seconds)
    rows, cols = cfg.vocab_size, cfg.d_model
    nf, ov = int(ErrorCode.NONFINITE_GRAD), int(ErrorCode.OVERFLOW)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
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
    out["probe_grad_embed"] = {
        "shape": f"1 x {rows * cols} bf16 (the {rows}x{cols} embedding's gradient), "
                 "threshold 1e4", "words": words, "max_abs_err": 0,
        "timing_copies": len(xs),
        "kernel_ms": time_ms(torch, lambda x: probe_rows(
            x, 1e4, nonfinite_code=nf, overflow_code=ov), xs),
        "plain_ms": time_ms(torch, lambda x: probe_rows_ref(
            x, 1e4, nonfinite_code=nf, overflow_code=ov), xs, launches=8),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    del x, xs
    return out


def train_profile(torch, step_fn, state, batch, ms_step: float) -> dict:
    """Where a train step's time goes: torch's profiler (CUPTI, device
    activity only) over one clean step from ``state`` (after one more as
    warm-up): the kernels' device time, the device's idle share of the
    unprofiled step (``ms_step``), and the kernels taking the most device
    time, each with its launches."""
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
    return {"device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1 - busy_ms / ms_step,
            "kernel_launches_per_step": sum(n for _, _, n in kernels),
            "top_kernels": [{"name": name[:90], "ms_per_step": ms, "launches": n}
                            for name, ms, n in top]}


def phase_train(torch, card: str, model) -> tuple:
    """Full-width training on the card (module docstring 11e): the train
    path's kernels at its shapes, then three runs of ``TRAIN_STEPS`` steps
    of ``ResilientExecutor`` over ``make_train_step``, each from a fresh
    copy of ``model``'s weights (the serving model is not changed) with zero
    moments: clean, faulted, LFLR. Returns ``(kernel rows, the clean run's
    launches)``."""
    import warnings
    from repro_torch.core import (ExecutorConfig, FaultSchedule, FaultSpec,
                                  ResilientExecutor)
    from repro_torch.core.detect import ProbeConfig
    from repro_torch.core.device_channel import readback
    from repro_torch.core.recovery import RecoveryPolicy
    from repro_torch.core.resilient import snapshot
    from repro_torch.data.pipeline import DataIterator, make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import make_reset_opt_fn
    from repro_torch.launch.train import build_train_setup
    from repro_torch.optim import init_opt_state
    from repro_torch.tree import tree_leaves
    from repro_torch.weights import train_params

    t_parts = {"start": time.perf_counter()}
    cfg = model.cfg
    kern = train_kernels(torch, cfg)
    t_parts["kernels"] = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated() / 1e9
    _, step_fn, state, pipe, opt_cfg = build_train_setup(
        cfg, batch_size=TRAIN_B, seq_len=TRAIN_S, seed=SEED, model=model,
        probe_cfg=ProbeConfig(loss_divergence_threshold=TRAIN_DIVERGENCE))
    n_leaves = len(state["params"])
    state_gb = sum(t.numel() * t.element_size() for t in tree_leaves(state)) / 1e9
    weights = {n: p.detach().clone() for n, p in list(model.named_parameters())[:3]}
    del state

    def fresh():
        """The run's start: a copy of the model's weights, zero moments."""
        params = train_params(model)
        return {"params": params, "opt": init_opt_state(params),
                "step": torch.zeros((), dtype=torch.int32, device=model.device),
                "lr_scale": torch.ones((), dtype=torch.float32, device=model.device)}

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
        return ex.run(fresh(), DataIterator(pipe.cfg, device=model.device),
                      TRAIN_STEPS, faults=FaultSchedule(
                          [FaultSpec(step=s, kind=k) for s, k in plan]))

    # 1. clean: one host sync a step (the port's counter, and torch's sync
    #    debug mode counting every synchronising call), the kernels' launches
    torch.cuda.synchronize()
    reset_launch_counts()
    syncs = readback.count
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
    syncs = readback.count - syncs
    sync_sites = Counter(f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                         for w in caught
                         if "called a synchronizing CUDA operation" in str(w.message))
    torch_syncs = sum(sync_sites.values())
    clean_losses = readback(torch.stack(losses)).tolist()
    step_ms = sorted(e.duration_s * 1e3 for e in log.events if e.kind == "ok" and e.step)
    ms_step = step_ms[len(step_ms) // 2]
    expected = dict.fromkeys(launches, 0)
    expected.update(flash_attention=TRAIN_STEPS * len(model.attn_layers),
                    flash_forward=TRAIN_STEPS * len(model.attn_layers),
                    probe_rows=TRAIN_STEPS * n_leaves)
    ok = [e.step for e in log.events if e.kind == "ok"]
    if (ok != list(range(TRAIN_STEPS)) or int(readback(state["step"])) != TRAIN_STEPS
            or syncs != TRAIN_STEPS or torch_syncs != TRAIN_STEPS
            or launches != expected or not all(map(math.isfinite, clean_losses))):
        fail(f"train (clean): ok steps {ok}, step {int(readback(state['step']))}, "
             f"syncs {syncs} (torch's sync debug mode: {torch_syncs} at "
             f"{dict(sync_sites)}; want {TRAIN_STEPS}), launches {launches} != {expected}, losses {clean_losses}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = snapshot(state)
    torch.cuda.synchronize()
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    del snap, state, log
    t_parts["clean"] = time.perf_counter()
    profile = train_profile(torch, step_fn, fresh(), make_batch(pipe.cfg, 0, model.device),
                            ms_step)
    t_parts["profile"] = time.perf_counter()
    stragglers = 0

    # 2. faulted: the reference policy's decisions, the constant the CPU
    #    test ties to the JAX executor
    state, log = run(TRAIN_FAULTS)
    events = tuple((e.step, e.kind, e.code, e.action) for e in log.events
                   if e.kind != "straggler")
    stragglers += sum(e.kind == "straggler" for e in log.events)
    if events != TRAIN_FAULT_EVENTS:
        fail(f"train (faulted): events {events} != {TRAIN_FAULT_EVENTS}")
    fault_losses = readback(torch.stack(losses)).tolist()
    del state, log
    t_parts["faulted"] = time.perf_counter()

    # 3. LFLR: skip, then restore to the snapshot after step 5; bit-equal to
    #    a clean run over the kept batches (the step is deterministic)
    state, log = run(TRAIN_LFLR_FAULTS)
    stragglers += sum(e.kind == "straggler" for e in log.events)
    acts = [(e.step, e.action) for e in log.faults()]
    clean = fresh()
    for i in TRAIN_LFLR_KEPT:
        clean, _, _ = step_fn(clean, make_batch(pipe.cfg, i, model.device), 0)
    a, b = tree_leaves(state), tree_leaves(clean)
    equal = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    unequal = [i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
    if acts != [(3, "skip_batch"), (8, "restore_good")] or not equal:
        fail(f"train (LFLR): actions {acts}, leaves unequal to the clean run "
             f"over {TRAIN_LFLR_KEPT}: {len(unequal)} of {len(b)} (first {unequal[:5]})")
    del state, clean, a, b, log
    t_parts["lflr"] = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 1e9
    untouched = (all(torch.equal(p, weights[n]) for n, p in model.named_parameters()
                     if n in weights)
                 and not any(p.requires_grad for p in model.parameters()))
    if not untouched:
        fail("train: the serving model's weights changed or require a gradient")
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train", "card": card, "model": cfg.name, "batch": TRAIN_B,
          "seq": TRAIN_S, "steps": TRAIN_STEPS, "leaves": n_leaves,
          "ms_per_step_median": ms_step, "ms_per_step": step_ms,
          "tokens_per_s": TRAIN_B * TRAIN_S / (ms_step / 1e3),
          "clean_run_s": clean_s, "syncs_per_step": syncs / TRAIN_STEPS,
          "torch_syncs": torch_syncs, "torch_sync_sites": dict(sync_sites),
          "snapshot_ms": snapshot_ms,
          "state_gb": state_gb, "mem_before_gb": mem_before, "peak_mem_gb": peak,
          "losses": clean_losses, "faulted_losses": fault_losses,
          "fault_events": [list(e) for e in events if e[1] == "fault"],
          "lflr_bit_equal": equal, "stragglers_flagged": stragglers,
          "divergence_threshold": TRAIN_DIVERGENCE, "lr_warmup": opt_cfg.warmup_steps,
          "launches": launches, "profile": profile, "kernels": kern,
          "seconds": time.perf_counter() - t_parts["start"],
          "seconds_by_part": {k: t_parts[k] - t_parts[j] for j, k in zip(
              list(t_parts)[:-1], list(t_parts)[1:])}})
    return kern, launches


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
    code = (ErrorCode.STATE_FAULT if model.state_leaf is not None
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
    """Each kernel against its plain version at recurrentgemma-2b's shapes."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.errors import ErrorCode
    from repro_torch.kernels import flash_attention, probe_rows, rglru_scan
    from repro_torch.kernels.fault_probe import probe_rows_ref
    from repro_torch.kernels.flash_attention import sdpa_ref
    from repro_torch.kernels.rglru_scan import rglru_scan_ref
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
    nf, ov = int(ErrorCode.NONFINITE_LOSS), int(ErrorCode.DIVERGENCE)
    rows, V = PREFILL_B * PREFILL_S, cfg.vocab_size
    x = f32(rows, V)
    x[rows - 1, V - 1] = float("nan")
    got = probe_rows(x, math.inf, nonfinite_code=nf, overflow_code=ov)
    want = probe_rows_ref(x, math.inf, nonfinite_code=nf, overflow_code=ov)
    err = (got - want).abs().max().item()
    if not torch.equal(got, want) or int(got.amax()) != nf or int(got[:-1].amax()) != 0:
        fail("probe_rows over the prefill logits disagrees with its plain version")
    del x, got, want
    xs = copies(lambda: (f32(rows, V),), rows * V * 4)
    b_ms, b_by = bound(rows * V * 4 + rows * 4, 3 * rows * V, PEAK_FP32_FLOPS)
    out["probe_prefill"] = {
        "shape": f"logits {rows}x{V} fp32, threshold inf", "max_abs_err": err,
        "timing_copies": len(xs),
        "kernel_ms": time_ms(torch, lambda x: probe_rows(
            x, math.inf, nonfinite_code=nf, overflow_code=ov), xs),
        "plain_ms": time_ms(torch, lambda x: probe_rows_ref(
            x, math.inf, nonfinite_code=nf, overflow_code=ov), xs, launches=8),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    del xs
    torch.cuda.empty_cache()
    emit({"phase": "kernels_rg", "card": card, **out})
    return out


def phase_kernels_g3(torch, card: str) -> dict:
    """flash and the probe against their plain versions at gemma3-1b's
    shapes (4/1 heads of 256): decode over the full cache and over the
    ring (wrapped), the sliding and the full forward at the prefill shape,
    the probe over the serve logits and over the prefill logits (2^31
    elements). Each flash row has controls that must exceed the limit."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.errors import ErrorCode
    from repro_torch.kernels import flash_attention, probe_rows
    from repro_torch.kernels.fault_probe import probe_rows_ref
    from repro_torch.kernels.flash_attention import sdpa_ref
    from repro_torch.kernels.flash_attention.ops import plan

    cfg = get_config("gemma3-1b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    f32 = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=gen, device=dev, dtype=torch.float32)
    randn = lambda *shape: f32(*shape).to(torch.bfloat16)  # noqa: E731
    heads_first = lambda *ts: tuple(t.transpose(1, 2) for t in ts)  # noqa: E731
    Hq, Hkv, D, win = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.sliding_window
    out = {}

    def flash_row(name, note, qs, kvs, off, kw, controls, kv_keys, flop_keys,
                  lib_kw, plain_launches=32):
        """One flash shape: the kernel against its plain version (and each
        control, which must exceed the limit), its time, the plain
        version's, the library call's and the bound. ``kv_keys``: the keys
        each K/V element read once counts; ``flop_keys``: the keys attended
        over all query rows."""
        q, k, v = randn(*qs), randn(*kvs), randn(*kvs)
        got, route = flash_call(flash_attention, q, k, v, off, **kw)
        want = sdpa_ref(q, k, v, q_offset=off, **kw)
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
        out[name] = {
            "shape": note, **route, "max_abs_err": err,
            "tol": f"{FLASH_RG_TOL[0]} abs + {FLASH_RG_TOL[1]} rel",
            "err_over_tol": excess, **{f"{c}_over_tol": x for c, x in ctl.items()},
            "timing_copies": len(qkv),
            "kernel_ms": time_ms(torch, lambda q, k, v: flash_attention(q, k, v, off, **kw), qkv),
            "plain_ms": time_ms(torch, lambda q, k, v: sdpa_ref(q, k, v, q_offset=off, **kw),
                                qkv, launches=plain_launches),
            "library_ms": time_ms(torch, lambda *t: F.scaled_dot_product_attention(
                *t, enable_gqa=True, **lib_kw), [heads_first(*t) for t in qkv]),
            "bound_ms": b_ms, "bound_by": b_by}
        del qkv
        torch.cuda.empty_cache()

    def decode_mask(pos, cap):
        off = torch.tensor(pos, dtype=torch.int32, device=dev)
        kpos = torch.arange(cap, device=dev)
        return off, (kpos[None, :] <= off[:, None])[:, None, None, :]

    # -- decode over the full layers' cache (cap MAX_LEN) and the ring (cap
    #    = the window, wrapped past it): the read is index < min(cap, pos + 1)
    for name, cap, pos in (
            ("flash_g3_decode", MAX_LEN, [0, 1, 300, 511, 512, 1000, MAX_LEN - 1, 1500]),
            ("flash_g3_ring_decode", win, [0, 1, win - 1, win, 600, 1023, 1024, 2000])):
        off, mask = decode_mask(pos, cap)
        ctx = sum(min(p + 1, cap) for p in pos)
        kw = {"causal": True, "seq_kv": cap}
        controls = {"one_key_dropped": lambda q, k, v, cap=cap, off=off: flash_attention(
            q, k, v, off, causal=True, seq_kv=cap - 1)}
        edge = plan(1, cap, Hkv, torch.bfloat16).keys_per_split
        if edge < cap:
            controls[f"key_{edge}_doubled"] = lambda q, k, v, cap=cap, off=off, edge=edge: (
                flash_attention(q, *key_doubled(k, v, edge), off, causal=True, seq_kv=cap))
        flash_row(name, f"q {NUM_SLOTS}x1x{Hq}x{D}, kv {NUM_SLOTS}x{cap}x{Hkv}x{D} bf16, "
                  f"pos {pos}", (NUM_SLOTS, 1, Hq, D), (NUM_SLOTS, cap, Hkv, D), off, kw,
                  controls, ctx, ctx, {"attn_mask": mask})

    # -- the forward at the prefill shape: sliding (window 512) and full
    Bp, Sp = PREFILL_B, PREFILL_S
    zero = torch.zeros(Bp, dtype=torch.int32, device=dev)
    qp = torch.arange(Sp, device=dev)
    mask = (qp[None, :] <= qp[:, None]) & (qp[None, :] > qp[:, None] - win)
    flash_row("flash_g3_sliding_forward",
              f"q {Bp}x{Sp}x{Hq}x{D}, kv {Bp}x{Sp}x{Hkv}x{D} bf16, causal, window {win}",
              (Bp, Sp, Hq, D), (Bp, Sp, Hkv, D), zero, {"causal": True, "window": win},
              {"window_one_short": lambda q, k, v: flash_attention(
                  q, k, v, zero, causal=True, window=win - 1)},
              Bp * Sp, Bp * sum(min(s + 1, win) for s in range(Sp)), {"attn_mask": mask},
              plain_launches=8)
    del mask
    flash_row("flash_g3_forward", f"q {Bp}x{Sp}x{Hq}x{D}, kv {Bp}x{Sp}x{Hkv}x{D} bf16, causal",
              (Bp, Sp, Hq, D), (Bp, Sp, Hkv, D), zero, {"causal": True},
              {"one_key_dropped": lambda q, k, v: flash_attention(
                  q, k, v, zero, causal=True, seq_kv=Sp - 1)},
              Bp * Sp, Bp * Sp * (Sp + 1) // 2, {"is_causal": True}, plain_launches=8)

    # -- the probe over the serve logits (slots, vocab 262144) fp32
    V = cfg.vocab_size
    nf, ov = int(ErrorCode.NONFINITE_LOSS), int(ErrorCode.DIVERGENCE)
    x = f32(NUM_SLOTS, V)
    x[3, V - 1] = float("nan")
    x[6, 0] = float("inf")
    got = probe_rows(x, math.inf, nonfinite_code=nf, overflow_code=ov)
    want = probe_rows_ref(x, math.inf, nonfinite_code=nf, overflow_code=ov)
    if not torch.equal(got, want) or got.tolist() != [0, 0, 0, nf, 0, 0, nf, 0]:
        fail(f"probe_rows over gemma3's logits wrong: {got.tolist()} vs {want.tolist()}")
    xs = copies(lambda: (f32(NUM_SLOTS, V),), NUM_SLOTS * V * 4)
    b_ms, b_by = bound(NUM_SLOTS * V * 4 + NUM_SLOTS * 4, 3 * NUM_SLOTS * V, PEAK_FP32_FLOPS)
    out["probe_g3_logits"] = {
        "shape": f"logits {NUM_SLOTS}x{V} fp32, threshold inf", "words": got.tolist(),
        "max_abs_err": (got - want).abs().max().item(), "timing_copies": len(xs),
        "kernel_ms": time_ms(torch, lambda x: probe_rows(
            x, math.inf, nonfinite_code=nf, overflow_code=ov), xs),
        "plain_ms": time_ms(torch, lambda x: probe_rows_ref(
            x, math.inf, nonfinite_code=nf, overflow_code=ov), xs),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    del x, xs
    torch.cuda.empty_cache()

    # -- the probe over the prefill logits (B * S, vocab) fp32: 2^31
    #    elements, 8 GiB; a NaN at the last one and an inf past row 4096
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
    mamba2-2.7b's shapes."""
    from repro_torch.configs import get_config
    from repro_torch.core.errors import ErrorCode
    from repro_torch.kernels import probe_rows, ssd_scan
    from repro_torch.kernels.fault_probe import probe_rows_ref
    from repro_torch.kernels.ssd_scan import (ssd_intra_chunk, ssd_intra_chunk_ref,
                                              ssd_scan_ref)
    from repro_torch.kernels.ssd_scan.ops import plan

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


def phase_prefill(torch, card: str, model, name: str) -> dict:
    """The prefill phases: the prefill step at (PREFILL_B, PREFILL_S), counts
    from 0."""
    import numpy as np
    from repro_torch.core.device_channel import readback
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import make_prefill_step

    cfg = model.cfg
    step = make_prefill_step(model)
    rng = np.random.default_rng(SEED + 2)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S)).astype(np.int64)).to(model.device)
    logits, word = step(tokens)                      # warm-up (cuBLAS plans)
    del logits, word
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    logits, word = step(tokens)
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
        logits, word = step(tokens)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del logits, word
    emit({"phase": name, "card": card, "model": cfg.name,
          "batch": PREFILL_B, "seq": PREFILL_S, "launches": launches,
          "mlp_activation": activation_cost(torch, model),
          "word": w, "first_ms": first_ms, "ms_per_call": sum(times) / len(times),
          "ms_calls": times, "tokens_per_s": PREFILL_B * PREFILL_S / (min(times) / 1e3),
          "peak_mem_gb": peak, "logits_gb": PREFILL_B * PREFILL_S * cfg.vocab_size * 4 / 1e9})
    return launches


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

    kern = phase_kernels(torch, card)
    model, init_s = build_model(torch, get_config("qwen3-1.7b"))
    # the first 10 requests only (cut from 16 when the train phase came, for
    # the run's time; two freed slots still refilled, and every later qwen3
    # phase serves at most these 10)
    serve_paths, serve_streams = phase_serve(torch, card, model, init_s, traced=True,
                                             n=REFILL_REQUESTS)
    engines = phase_engines(torch, card, model)
    for name, engine in (("lflr_stepwise", "stepwise"), ("lflr_blocking", "blocking")):
        phase_lflr_engine(torch, card, model, name, ENGINES[engine],
                          engines["streams"][engine])
    # the first 10 requests only (cut from 16 when the traced and fuzz
    # phases came, for the run's time; two freed slots still refilled)
    serve_paged, paged_streams = phase_serve(
        torch, card, model, init_s, ("serve_paged", "lflr_paged"), paged=True,
        n=REFILL_REQUESTS, want={i: serve_streams[i] for i in range(REFILL_REQUESTS)})
    # the first 8 requests only (cut when the speculative phases came, to
    # keep the run's time): page_fault still corrupts a decoding lane, and
    # 8 lanes still outgrow the 64-page pool
    phase_page_fault(torch, card, model, paged_streams)
    phase_paged_pressure(torch, card, model, serve_streams)
    engines_paged = phase_engines_paged(torch, card, model,
                                        engines["streams"]["blocking"])
    spec_paths = phase_spec(torch, card, model, init_s, serve_streams)
    group_paths = phase_group(torch, card, model, serve_streams)
    fuzz_paths = phase_fuzz(torch, card, model)
    kern_train, train_launches = phase_train(torch, card, model)
    del model                                     # free qwen3 before rg
    gc.collect()
    torch.cuda.empty_cache()

    kern_rg = phase_kernels_rg(torch, card)
    model, init_s = build_model(torch, get_config("recurrentgemma-2b"))
    # the first 10 requests only (cut from 16 when the traced and fuzz
    # phases came, for the run's time; two freed recurrent slots still
    # refilled)
    serve_rg, _ = phase_serve(torch, card, model, init_s, ("serve_rg", "lflr_rg"),
                              n=REFILL_REQUESTS)
    phase_lflr_stepwise_rg(torch, card, model)
    prefill_rg = phase_prefill(torch, card, model, "prefill_rg")
    del model                                     # free rg before mamba2
    gc.collect()
    torch.cuda.empty_cache()

    kern_ssm = phase_kernels_ssm(torch, card)
    model, init_s = build_model(torch, get_config("mamba2-2.7b"))
    # the first 8 requests only (one per slot): the mamba2 phases are the
    # run's slowest, cut to leave time for the paged phases
    serve_ssm, _ = phase_serve(torch, card, model, init_s, ("serve_ssm", "lflr_ssm"),
                               n=NUM_SLOTS)
    prefill_ssm = phase_prefill(torch, card, model, "prefill_ssm")
    del model                                     # free mamba2 before gemma3
    gc.collect()
    torch.cuda.empty_cache()

    kern_g3 = phase_kernels_g3(torch, card)
    model, init_s = build_model(torch, get_config("gemma3-1b"))
    # the fault: K of layer 5, the first full layer (max_len > the window);
    # the first 10 requests only (cut from 16 when the train phase came, for
    # the run's time: 79 windows against 93; the two long prompts among
    # them, two slots refilled)
    serve_g3, g3_streams = phase_serve(torch, card, model, init_s,
                                       ("serve_g3", "lflr_g3"), long=2,
                                       poison_layers=[5], n=REFILL_REQUESTS)
    # the same through the pool, on the first 8 requests (the two long
    # prompts among them; cut when the speculative phases came, to keep the
    # run's time): the 4 full layers paged, the rings dense; the fault goes
    # into K of layer 5, now a pool page
    serve_g3_paged, _ = phase_serve(
        torch, card, model, init_s, ("serve_g3_paged", "lflr_g3_paged"), long=2,
        poison_layers=[5], paged=True, n=NUM_SLOTS,
        want={i: g3_streams[i] for i in range(NUM_SLOTS)})
    prefill_g3 = phase_prefill(torch, card, model, "prefill_g3")
    del model
    paths = {**serve_paths,
             **{f"engines_{e}": c for e, c in engines["launches"].items()},
             **serve_paged, "engines_paged": engines_paged,
             **spec_paths, **group_paths, **fuzz_paths, "train": train_launches,
             **serve_g3_paged,
             **serve_rg, "prefill_rg": prefill_rg,
             **serve_ssm, "prefill_ssm": prefill_ssm,
             **serve_g3, "prefill_g3": prefill_g3}
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
             "flash_f32_decode": kern["flash_f32_decode"],
             "flash_f32_forward": kern["flash_f32_forward"],
             "flash_ring_decode": kern_rg["flash_ring_decode"],
             "flash_sliding_forward": kern_rg["flash_sliding_forward"],
             **{n: kern_g3[n] for n in ("flash_g3_decode", "flash_g3_ring_decode",
                                        "flash_g3_sliding_forward", "flash_g3_forward")}},
            launches_by_kernel={k: by_path(k) for k in (
                "flash_decode", "flash_verify", "flash_forward", "flash_f32")}),
        kernel_entry(
            "probe_rows", "src/repro_torch/kernels/fault_probe/csrc/fault_probe.cu",
            "src/repro/kernels/fault_probe/kernel.py:44",
            by_path("probe_rows"), kern["probe_rows"],
            {"probe_rows": kern["probe_rows"], "probe_verify": kern["probe_verify"],
             "probe_state": kern_rg["probe_state"],
             "probe_prefill": kern_rg["probe_prefill"],
             "probe_ssm": kern_ssm["probe_ssm"],
             "probe_g3_logits": kern_g3["probe_g3_logits"],
             "probe_g3_prefill": kern_g3["probe_g3_prefill"],
             "probe_grad_embed": kern_train["probe_grad_embed"]}),
        kernel_entry(
            "rglru_scan", "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
            "src/repro/kernels/rglru_scan/kernel.py:36",
            by_path("rglru_scan"), kern_rg["rglru_scan"],
            {n: kern_rg[n] for n in ("rglru_scan", "rglru_scan_long_memory")}),
        kernel_entry(
            "ssd_scan", kern_ssm["ssd_scan"]["source"],
            "src/repro/kernels/ssd_scan/kernel.py:47",
            by_path("ssd_scan"), kern_ssm["ssd_scan"],
            {"ssd_scan": kern_ssm["ssd_scan"],
             "ssd_scan_groups": kern_ssm["ssd_scan_groups"],
             "ssd_f32": kern_ssm["ssd_f32"]},
            launches_by_kernel={k: by_path(k) for k in ("ssd_chunk_tc", "ssd_f32")}),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
