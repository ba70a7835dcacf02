"""Run one cell of BENCHMARK.json once and print its result line.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout (``python3 -m perfbench.run`` works too).  The
run makes its content from the seed on the card, loads the program and
warms every shape the cell uses (set-up, reported as ``setup_s``), runs
the cell's closed loop for S seconds, then checks what the window produced
against the float64 reference (checks.py) and prints, as its last lines on
standard error, each number compared beside its limit, and as the last
line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics, read from a torch.profiler trace of a
sub-window), ``device``, with ``--trace 1`` ``breakdown``, and ``checks``.

It needs a CUDA card and never falls back to the CPU; it exits non-zero
and prints no result without one, and when ``jax``, ``jaxlib``, ``flax``
or the JAX package ``dct3d_tpu`` has been loaded into the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import struct  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import spec  # noqa: E402

BANNED = frozenset({"jax", "jaxlib", "flax", "dct3d_tpu"})


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is banned."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in BANNED})


def cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout.  The
    program builds its own libraries in dct3d_tpu_torch/_build and
    dct3d_tpu_torch/native/_build."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def smi() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


class RunData:
    """What the per-layer readers read: the trace of the profiled
    sub-window, the records of its operations, GOP counts and per-GOP
    facts by phase."""

    def __init__(self, trace, records: list[dict], gops: dict, facts: dict) -> None:
        self.trace, self.records, self.gops, self.facts = trace, records, gops, facts


def _facts(cfg, h: int, w: int, containers: list[bytes]) -> dict:
    """Per-GOP facts of the profiled operations, by phase, for the kernels'
    byte counts: geometry, value width, and the mean stream bits and
    exceptions of the GOPs that ``containers`` hold."""
    from perfbench import reference

    base = {"frames": cfg.gop_size, "height": h, "width": w, "cube": cfg.cube_size,
            "cubes": (h // cfg.block_h) * (w // cfg.block_w),
            "value_bytes": 2 if cfg.compute_dtype == "bfloat16" else 4,
            "stream_bits": 0.0, "exceptions": 0.0}
    bits = exc = gops = 0
    for data in containers:
        try:
            members = reference.split_members(data)
            for kind, frames, payload in members:
                if kind == reference.INDEX:
                    ends, _ = reference.parse_index(payload)
                    bits += ends[-1] if ends else 0
                elif kind == reference.TURBO:
                    a, b, c, _ = struct.unpack_from("<IIII", payload, 0)
                    exc += len(reference.inflate(payload[16 + a + b : 16 + a + b + c])) // 4
                gops += frames // cfg.gop_size if kind != reference.INDEX else 0
        except ValueError:
            continue
    enc = dict(base)
    if gops:
        enc.update(stream_bits=bits / gops, exceptions=exc / gops)
    return {"encode": enc, "decode": dict(base), "seek": dict(base)}


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float | None = None, dtype: str | None = None,
             overrides: dict | None = None) -> dict:
    """One run of ``cell`` on ``device``; returns the result object.

    ``overrides`` ({"config": {...}, "traffic": {...}}) resize a cell for
    the CPU tests; ``dtype`` swaps the configuration's compute dtype."""
    import numpy as np
    import torch

    from perfbench import checks, reference, sut, trace

    t_start = time.perf_counter() if t_start is None else t_start
    overrides = overrides or {}
    config = {**cell.config, **overrides.get("config", {})}
    traffic = {**cell.traffic, **overrides.get("traffic", {})}
    seed = seed % (1 << 63)
    on_card = device.type == "cuda"

    codec = sut.Codec(config, device, compute_dtype=dtype)
    loop = spec.loop_class(traffic["loop"], cell.root)(
        codec, traffic, config, seed, device, spec.generator(traffic["content"], cell.root))
    cards = [torch.device("cuda", i) for i in range(cell.chips)] if on_card else []
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    loop.warm_up()
    for d in cards:
        torch.cuda.synchronize(d)
    setup_s = time.perf_counter() - t_start

    prof = trace.Profiler(traced, traffic["trace_first"], traffic["trace_ops"], len(cards))
    loop.window(seconds, prof)
    prof.close()
    for d in cards:
        torch.cuda.synchronize(d)
    memory_peak = max((torch.cuda.max_memory_allocated(d) for d in cards), default=0)

    result: dict = {"correct": False, "attempted": loop.attempted(), "failed": loop.failed}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": memory_peak}
    if traced:
        t = prof.trace
        if t is None or t.window[1] <= t.window[0]:
            raise RuntimeError("the window ended before the profiled operations")
        ops = slice(traffic["trace_first"], traffic["trace_first"] + traffic["trace_ops"])
        records = loop.records[ops]
        n = sum(r["gops"] for r in records)
        gops = {p: n for p in loop.phases}
        h, w = loop.pool.frames.shape[1:]
        run = RunData(t, records, gops,
                      _facts(codec.cfg, h, w, [r.get("data", b"") for r in records]))
        metrics = {}
        for m in cell.per_layer:
            read, part = spec.layer_reader(m["name"])
            value = read(run, part)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        window = [(t.window[0], t.window[1])]
        device_info["busy_s"] = t.busy(window) / 1e6
        device_info["window_s"] = (t.window[1] - t.window[0]) / 1e6
    else:
        values = {**loop.end_to_end(), "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = device_info
    if traced:
        result["breakdown"] = prof.trace.breakdown()

    if on_card:
        print(f"card: {smi()}; roofline peak {spec.peaks()['hbm_bytes_per_s']:.3g} B/s "
              f"({spec.peaks()['device']}, {spec.peaks()['power_limit_w']} W); "
              f"memory peak {memory_peak} B; set-up {setup_s:.3f} s", file=sys.stderr)

    # The check, once the program's state is freed.
    t_check = time.perf_counter()
    loop.release()
    del codec
    for d in cards:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()
    b = config["codec"]
    tr = reference.Transform((b["block_w"], b["block_h"], b["block_d"]),
                             b["quant_strength"], b["quant_bias"], device)
    verdict = checks.Verdict()
    loop.check(tr, verdict, np.random.default_rng([seed, 4]))
    if verdict.judged == 0:
        verdict.broke("nothing was compared")
    for what in verdict.broken:
        print(f"check: {what}", file=sys.stderr)
    print(f"check: {verdict.judged} comparisons in {time.perf_counter() - t_check:.2f} s; "
          f"PSNR of the sampled GOPs {[round(float(p), 3) for p in verdict.psnr]} dB", file=sys.stderr)
    result["correct"] = verdict.passed() and loop.failed == 0
    result["checks"] = verdict.as_dict()
    return result


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs(spec.ROOT)
    cell = spec.Cell(spec.benchmark(), args.workload)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start=T_START)
    found = banned_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
