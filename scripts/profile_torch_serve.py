#!/usr/bin/env python3
"""Where one serve window's time goes, for the PyTorch/CUDA port on one GPU.

Builds the ``chip_smoke.py`` serve configuration (full-width qwen3-1.7b,
seeded random weights, ``Replica(window=8, overlap=True, num_slots=8,
max_len=1024)``), warms it up, fills all slots with decoding requests and
profiles a few steady decode windows with ``torch.profiler`` (CPU and CUDA
activities). Prints one JSON line: wall ms per window step, device busy ms
per step (sum of kernel times), the device idle share, operator launches
per step, and the top operators by host and by device time.

    python3 scripts/profile_torch_serve.py [--windows N]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_serve: needs a CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import EngineConfig, Replica, Request

    cfg = get_config("qwen3-1.7b")
    window, slots = 8, 8
    rep = Replica(cfg, Model(cfg, device="cuda", seed=0), config=EngineConfig(
        window=window, overlap=True, num_slots=slots, max_len=1024))
    rep.warmup()
    for i in range(slots):
        rep.submit(Request(id=i, prompt=tuple(range(10 + i, 42 + i)),
                           max_new_tokens=400))
    while any(s.pending is not None or not s.active for s in rep.sched.slots):
        rep.step()                       # admit and prefill every slot
    for _ in range(3):
        rep.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.windows):
            rep.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = args.windows * window
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    aten = [e for e in events if e.key.startswith("aten::")]
    top = lambda key: [  # noqa: E731
        {"op": e.key, "count_per_step": e.count / steps,
         "host_us_per_step": e.self_cpu_time_total / steps,
         "device_us_per_step": device_us(e) / steps}
        for e in sorted(events, key=key, reverse=True)[:15]]
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "windows": args.windows,
        "steps": steps, "wall_ms_per_step": wall / steps * 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": max(0.0, 1 - busy_us / 1e6 / wall),
        "aten_ops_per_step": sum(e.count for e in aten) / steps,
        "kernels_per_step": len(kernels) / steps,
        "top_host": top(lambda e: e.self_cpu_time_total),
        "top_device": top(device_us)}))


if __name__ == "__main__":
    main()
