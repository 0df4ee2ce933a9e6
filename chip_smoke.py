#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line (``"phase": ...``):

1. device  — the card, its capability (Hopper, 9.0 required) and the
   ``nvidia-smi`` name and power limit (also printed raw on a line of its own);
2. build   — builds every kernel of the port from the checkout's sources;
3. kernels — holds each kernel against its plain PyTorch version on the card
   at the serve path's shapes, with the stated tolerances, and times the
   kernel, the plain version and (where one exists) one PyTorch library call
   computing the same function, beside the least time the card could take;
4. serve   — full-width qwen3-1.7b (28 layers, bf16, seeded random weights)
   served by ``Replica(window=8, overlap=True, num_slots=8, max_len=1024)``:
   16 requests with 16–256-token prompts and 64 new tokens each. Every
   request must be answered OK, the kernels' launch counts must show the path
   went through them, and one answer is held against a full forward;
5. lflr    — the same traffic again with a NaN injected into an active slot's
   KV cache mid-run: the probe kernel must latch NONFINITE_LOSS, and every
   stream must be bit-equal to phase 4.

Then the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Any failure exits non-zero before the last line is printed.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20             # H100 L2 cache
ROTATE_BYTES = 2 * L2_BYTES         # inputs rotated through per timing run
SPIN_CYCLES = 5 * 10 ** 7           # ~25 ms at 1.98 GHz: the host's head start
NUM_SLOTS, MAX_LEN, WINDOW = 8, 1024, 8
NUM_REQUESTS, MAX_NEW = 16, 64
FLASH_TOL = 1.6e-2                  # bf16 outputs: 2 ulp at |x| < 2
FORWARD_GAP_TOL = 2.0               # decode vs forward logits, bf16, 28 layers


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def copies(make, nbytes: int) -> list:
    """Enough independent copies of one call's inputs (``make()`` builds one,
    of ``nbytes``) that a timing run rotating through them outgrows the L2
    cache: each copy is evicted before its next use, so the inputs come from
    device memory, as on the serve path."""
    return [make() for _ in range(max(2, math.ceil(ROTATE_BYTES / nbytes)))]


def time_ms(torch, fn, inputs: list, *, launches: int = 32) -> float:
    """Mean device time of ``fn(*args)`` over one run of at least
    ``launches`` calls between one CUDA event pair, rotating over ``inputs``.

    A spin kernel queued ahead of the start event holds the device while the
    host queues the whole run, so the wrapper's host work never lands
    between launches. If the device has already passed the start event when
    the last call is queued, the run is repeated with a longer spin."""
    for args in inputs:
        fn(*args)
    n = max(launches, len(inputs))
    spin = SPIN_CYCLES
    for _ in range(3):
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


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    so = build.build()
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(so, ROOT),
          "sources": [os.path.relpath(s, ROOT) for s in build.sources()]})


def phase_kernels(torch, card: str) -> dict:
    """Each kernel against its plain version at the serve path's shapes."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.core.errors import ErrorCode
    from repro_torch.kernels import flash_attention, probe_rows
    from repro_torch.kernels.fault_probe import probe_rows_ref
    from repro_torch.kernels.flash_attention import sdpa_ref

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
    got = flash_attention(q, k, v, off, causal=True, seq_kv=MAX_LEN)
    want = sdpa_ref(q, k, v, q_offset=off, causal=True, seq_kv=MAX_LEN)
    err = (got.float() - want.float()).abs().max().item()
    if not err <= FLASH_TOL:
        fail(f"flash decode disagrees with its plain version: {err}")
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
        "shape": f"q {B}x1x{Hq}x{D}, kv {B}x{MAX_LEN}x{Hkv}x{D} bf16, pos {pos}",
        "max_abs_err": err, "tol": FLASH_TOL, "library_err": lib_err,
        "timing_copies": len(qkv),
        "kernel_ms": time_ms(torch, lambda q, k, v: flash_attention(
            q, k, v, off, causal=True, seq_kv=MAX_LEN), qkv),
        "plain_ms": time_ms(torch, lambda q, k, v: sdpa_ref(
            q, k, v, q_offset=off, causal=True, seq_kv=MAX_LEN), qkv),
        "library_ms": time_ms(torch, lambda *t: F.scaled_dot_product_attention(
            *t, attn_mask=mask, enable_gqa=True), [heads_first(*t) for t in qkv]),
        "bound_ms": b_ms, "bound_by": b_by}

    # -- flash forward: B 1, S 512, causal (Model.forward's shape)
    S = 512
    q, k, v = randn(1, S, Hq, D), randn(1, S, Hkv, D), randn(1, S, Hkv, D)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    got = flash_attention(q, k, v, zero, causal=True)
    want = sdpa_ref(q, k, v, q_offset=zero, causal=True)
    err = (got.float() - want.float()).abs().max().item()
    if not err <= FLASH_TOL:
        fail(f"flash forward disagrees with its plain version: {err}")
    nbytes = 2 * S * Hq * D * 2 + 2 * S * Hkv * D * 2 + 4
    flops = 4 * Hq * D * S * (S + 1) // 2
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    qkv = copies(lambda: (randn(1, S, Hq, D), randn(1, S, Hkv, D),
                          randn(1, S, Hkv, D)), S * (Hq + 2 * Hkv) * D * 2)
    out["flash_forward"] = {
        "shape": f"q 1x{S}x{Hq}x{D}, kv 1x{S}x{Hkv}x{D} bf16, causal",
        "max_abs_err": err, "tol": FLASH_TOL, "timing_copies": len(qkv),
        "kernel_ms": time_ms(torch, lambda q, k, v: flash_attention(
            q, k, v, zero, causal=True), qkv),
        "plain_ms": time_ms(torch, lambda q, k, v: sdpa_ref(
            q, k, v, q_offset=zero, causal=True), qkv),
        "library_ms": time_ms(torch, lambda *t: F.scaled_dot_product_attention(
            *t, is_causal=True, enable_gqa=True), [heads_first(*t) for t in qkv]),
        "bound_ms": b_ms, "bound_by": b_by}

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
    emit({"phase": "kernels", "card": card, **out})
    return out


def make_requests(cfg, Request):
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    return [Request(id=i,
                    prompt=tuple(int(t) for t in rng.integers(
                        0, cfg.vocab_size, int(rng.integers(16, 257)))),
                    max_new_tokens=MAX_NEW)
            for i in range(NUM_REQUESTS)]


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


def phase_serve(torch, card: str, cfg) -> dict:
    from repro_torch.core.device_channel import readback
    from repro_torch.core.errors import ErrorCode
    from repro_torch.kernels import flash_attention, probe_rows, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.serve import EngineConfig, Replica, Request, ServeMetrics

    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    rep = Replica(cfg, model, config=EngineConfig(
        window=WINDOW, overlap=True, num_slots=NUM_SLOTS, max_len=MAX_LEN))
    t0 = time.perf_counter()
    rep.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    # ---- phase 4: the main path, counts from 0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    readback.count = 0
    t0 = time.perf_counter()
    clean, _ = drive(rep, make_requests(cfg, Request))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "probe_rows": probe_rows.launches}
    syncs = readback.count
    m = rep.metrics
    bad = [r.id for r in clean.values() if not r.ok or len(r.tokens) != MAX_NEW]
    if len(clean) != NUM_REQUESTS or bad:
        fail(f"serve: {len(clean)} answers, not OK or short: {bad}")
    steps = WINDOW * m.windows
    expected = {"flash_attention": cfg.num_layers * steps, "probe_rows": steps}
    if launches != expected:
        fail(f"kernel launches {launches} != {expected} "
             f"({cfg.num_layers} layers x {steps} window steps)")
    if m.faults:
        fail(f"clean run recorded faults: {m.faults}")
    tokens = sum(len(r.tokens) for r in clean.values())
    forward = check_against_forward(torch, model, clean, make_requests(cfg, Request))
    emit({"phase": "serve", "card": card, "model": cfg.name,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "weight_gb": weight_bytes / 1e9,
          "init_s": init_s, "warmup_s": warmup_s, "requests": len(clean),
          "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
          "windows": m.windows, "steps": steps, "ms_per_step": wall / steps * 1e3,
          "syncs": syncs, "window_waits": m.window_waits, "launches": launches,
          "ttft_p50_s": m.ttft_percentiles()["p50"],
          "latency_p99_s": m.latency_percentiles()["p99"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "forward_check": forward})

    # ---- phase 5: same traffic, a NaN in an active slot's KV mid-run
    rep.metrics = ServeMetrics()
    state = {"cycles": 0, "slot": None}

    def inject(r) -> bool:
        state["cycles"] += 1
        if state["cycles"] < 6:
            return False
        for s in r.sched.slots:
            # decoding, and busy past the in-flight and the next window
            if (s.active and s.pending is None and s.generated
                    and MAX_NEW - len(s.generated) > 2 * WINDOW):
                state["slot"] = r.inject_state_fault(s.idx)
                return True
        return False

    t0 = time.perf_counter()
    faulted, injected = drive(rep, make_requests(cfg, Request), inject)
    torch.cuda.synchronize()
    lflr_wall = time.perf_counter() - t0
    fm = rep.metrics
    if not injected:
        fail("lflr: no decoding slot to poison")
    nonfinite = [f for f in fm.faults
                 if f.code & int(ErrorCode.NONFINITE_LOSS)]
    if not nonfinite or state["slot"] not in nonfinite[0].slots:
        fail(f"lflr: the probe did not latch NONFINITE_LOSS on slot "
             f"{state['slot']}: {fm.faults}")
    diff = [i for i in clean if faulted.get(i) is None
            or not faulted[i].ok or faulted[i].tokens != clean[i].tokens]
    if diff:
        fail(f"lflr: streams differ from the clean run for requests {diff}")
    emit({"phase": "lflr", "card": card, "poisoned_slot": state["slot"],
          "faults": [{"step": f.step, "code": f.code, "action": f.action,
                      "slots": list(f.slots)} for f in fm.faults],
          "recovery_action": nonfinite[0].action,
          "retries": sum(r.retries for r in faulted.values()),
          "streams_bit_equal": True, "wall_s": lflr_wall})
    return launches


def check_against_forward(torch, model, answers, reqs) -> dict:
    """Hold one served stream against a full forward (the flash kernel at
    prefill shape): every served token must be the forward's argmax, or
    within ``FORWARD_GAP_TOL`` of it (bf16 decode and forward round
    differently over 28 layers)."""
    req = min(reqs, key=lambda r: len(r.prompt))
    toks = list(req.prompt) + list(answers[req.id].tokens)
    with torch.no_grad():
        logits = model(torch.tensor([toks], device=model.device))[0]
    if not bool(torch.isfinite(logits).all()):
        fail("forward logits are not finite")
    n = len(req.prompt)
    rows = logits[n - 1:len(toks) - 1]
    served = torch.tensor(answers[req.id].tokens, device=model.device)
    gap = (rows.max(dim=-1).values - rows.gather(1, served[:, None])[:, 0])
    agree = int((gap == 0).sum())
    worst = float(gap.max())
    if worst > FORWARD_GAP_TOL:
        fail(f"served stream of request {req.id} disagrees with the forward "
             f"(largest logit gap {worst})")
    return {"request": req.id, "positions": len(served), "argmax_agree": agree,
            "max_gap": worst, "tol": FORWARD_GAP_TOL}


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
    kern = phase_kernels(torch, card)
    from repro_torch.configs import get_config
    launches = phase_serve(torch, card, get_config("qwen3-1.7b"))
    emit({"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:81",
         "launches": launches["flash_attention"],
         "ms": kern["flash_decode"]["kernel_ms"],
         **{k: kern["flash_decode"][k] for k in (
             "max_abs_err", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        {"name": "probe_rows", "route": "cuda",
         "source": "src/repro_torch/kernels/fault_probe/csrc/fault_probe.cu",
         "replaces": "src/repro/kernels/fault_probe/kernel.py:44",
         "launches": launches["probe_rows"],
         "ms": kern["probe_rows"]["kernel_ms"],
         **{k: kern["probe_rows"][k] for k in (
             "max_abs_err", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
