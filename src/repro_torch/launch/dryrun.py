"""One card's dry run: every (arch × input-shape) cell's step built at full
width and depth on fake tensors, and its FLOPs, bytes and peak memory
counted, with no card and no memory.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --perf mb=8,ce=2048 \
        --out artifacts/dryrun

The port of ``repro/launch/dryrun.py``. The reference lowers and compiles
every cell on the TPU pod meshes of ``launch/mesh.py`` (16×16 chips, and
2×16×16 across two pods), which need the sharding rules of tensor
parallelism: the port has neither yet (ROADMAP item 11), and runs each
cell as one H100's step (``mesh: "1xH100"``, ``chips: 1``). Each cell's
step is the reference's kind — ``make_train_step`` over a train state,
``make_prefill_step``, or the decode step over ``init_cache(B, S)`` — run
once under ``FakeTensorMode`` on the CPU inside a
:class:`~repro_torch.roofline.dispatch.DispatchCount`. Every hand-written
kernel's plain version stands in for it there (a fake tensor lies on the
CPU), counted as the kernel's own inputs and outputs. The peak is the most
bytes the step's arguments and live tensors hold at once: what the card's
allocator would hold at least; ``fits`` says whether it stays within the
card's 80 GB.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import ARCHS, SHAPES, ShapeConfig, cell_skip_reason, get_config
from ..roofline.analysis import RooflineTerms, model_flops_for
from ..roofline.dispatch import DispatchCount, estimate_hbm_bytes, op_histogram

MESH = "1xH100"
CARD_BYTES = 80e9
# the reference's PerfOptions spec keys this dry run honours, by field
LEVERS = {"mb": "microbatch", "microbatch": "microbatch",
          "ce": "ce_chunk", "ce_chunk": "ce_chunk"}
# its levers that shard over TPU chips: they wait for the sharding rules
SHARDING_LEVERS = ("sp", "seq_shard", "cacheseq", "cache_seq_model", "ep",
                   "ep_constraint")


def parse_perf(spec: str) -> dict:
    """``'mb=8,ce=2048'`` (the reference's ``PerfOptions.parse`` keys) →
    ``{"microbatch": 8, "ce_chunk": 2048}``. The sharding levers are
    refused: they wait for ROADMAP item 11."""
    out = {"microbatch": 0, "ce_chunk": 0}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        key, _, value = part.partition("=")
        if key in SHARDING_LEVERS:
            raise ValueError(f"--perf {key}: a lever that shards over TPU chips; "
                             "it waits for tensor parallelism (ROADMAP item 11)")
        if key not in LEVERS:
            raise ValueError(f"--perf {key}: not a lever of the dry run "
                             f"(known: {sorted(LEVERS)})")
        out[LEVERS[key]] = int(value)
    return out


def _batch(cfg, B: int, S: int) -> dict:
    """A batch of the family's keys (``make_batch``'s), zeros."""
    batch = {"labels": torch.zeros((B, S), dtype=torch.int32)}
    if cfg.family == "audio":
        batch["inputs_embeds"] = torch.zeros((B, S, cfg.d_model))
    else:
        batch["tokens"] = torch.zeros((B, S), dtype=torch.int32)
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.zeros((B, cfg.img_tokens, cfg.d_model))
    return batch


def _cell_step(cfg, shape: ShapeConfig, perf: dict):
    """``(step, args)`` of the cell, made on fake tensors (the caller's
    ``FakeTensorMode``)."""
    from ..models import Model
    from ..optim import init_opt_state
    from ..weights import train_params
    from .steps import make_decode_step, make_prefill_step, make_train_step

    B, S = shape.global_batch, shape.seq_len
    model = Model(cfg, device="cpu", seed=0)
    if shape.kind == "train":
        params = train_params(model)
        state = {"params": params, "opt": init_opt_state(params),
                 "step": torch.zeros((), dtype=torch.int32),
                 "lr_scale": torch.ones(())}
        return make_train_step(cfg, **perf), (state, _batch(cfg, B, S), 0)
    params = dict(model.named_parameters())
    if shape.kind == "prefill":
        batch = _batch(cfg, B, S)
        step = make_prefill_step(model)
        return (lambda params, batch: step(batch.get("tokens"),
                                           inputs_embeds=batch.get("inputs_embeds"),
                                           img_embeds=batch.get("img_embeds")),
                (params, batch))
    step = make_decode_step(model)
    cache = model.init_cache(B, S)
    token = torch.zeros((B, 1), dtype=torch.int32)
    return (lambda params, cache, token: step(cache, token, S - 1),
            (params, cache, token))


def run_cell(arch: str, shape, *, perf="", config_override=None) -> dict:
    """Count one cell's step; returns the artifact dict. ``shape`` is a
    name in ``SHAPES`` or a :class:`ShapeConfig`; ``perf`` a spec string
    or :func:`parse_perf`'s dict; ``config_override`` replaces the arch's
    config (e.g. cut in depth)."""
    cfg = config_override or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    perf = parse_perf(perf) if isinstance(perf, str) else dict(perf)
    rec: dict = {"arch": arch, "shape": shape.name, "mesh": MESH, "chips": 1,
                 "ok": False, "perf": perf}
    t0 = time.monotonic()
    try:
        with FakeTensorMode(), torch.no_grad():
            step, args = _cell_step(cfg, shape, perf)
            arg_bytes = sum(t.numel() * t.element_size()
                            for t in torch.utils._pytree.tree_leaves(args)
                            if isinstance(t, torch.Tensor))
            with DispatchCount() as count:
                count.track(args)
                step(*args)
        hbm = estimate_hbm_bytes(count)
        terms = RooflineTerms(chips=1, hlo_flops_per_device=float(count.flops),
                              hlo_bytes_per_device=float(hbm["total_bytes"]),
                              collective_bytes_per_device=0.0,
                              model_flops=model_flops_for(cfg, shape))
        hist = op_histogram(count)
        rec.update(
            ok=True,
            flops=float(count.flops),
            boundary_bytes=float(hbm["total_bytes"]),
            memory={"argument_bytes": arg_bytes,
                    "peak_live_bytes": count.peak_bytes,
                    "card_bytes": CARD_BYTES},
            fits=count.peak_bytes <= CARD_BYTES,
            roofline=terms.to_dict(),
            aten_ops=dict(list(hist.items())[:20]),
            kernels={k: v for k, v in hist.items() if k.startswith("kernel.")},
        )
    except Exception as e:  # noqa: BLE001 - a failing cell is a reported bug
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.monotonic() - t0, 2)
    return rec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--include-skipped", action="store_true",
                    help="attempt cells that are documented skips")
    ap.add_argument("--perf", default="",
                    help="perf levers, e.g. 'mb=8,ce=2048'")
    args = ap.parse_args(argv)
    perf = parse_perf(args.perf)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    failures = 0
    for arch in archs:
        for shape in shapes:
            reason = cell_skip_reason(arch, shape)
            if reason and not args.include_skipped:
                _write(out_dir, {"arch": arch, "shape": shape, "mesh": MESH,
                                 "ok": True, "skipped": reason})
                print(f"SKIP  {arch:24s} {shape:12s} ({reason})", flush=True)
                continue
            rec = run_cell(arch, shape, perf=perf)
            _write(out_dir, rec)
            if rec["ok"]:
                r = rec["roofline"]
                print(f"OK    {arch:24s} {shape:12s} {MESH:8s} "
                      f"count={rec['total_s']:7.1f}s "
                      f"dom={r['dominant']:10s} "
                      f"frac={r['roofline_fraction']:.3f} "
                      f"peak={rec['memory']['peak_live_bytes'] / 2**30:.2f}GiB "
                      f"fits={rec['fits']}", flush=True)
            else:
                failures += 1
                print(f"FAIL  {arch:24s} {shape:12s} {MESH:8s} "
                      f"{rec['error']}", flush=True)
    print(f"\ndone; failures={failures}")
    return 1 if failures else 0


def _write(out_dir: Path, rec: dict) -> None:
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json".replace("/", "_")
    (out_dir / name).write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    raise SystemExit(main())
