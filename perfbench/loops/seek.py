"""``seek``: a closed loop of one client sending range requests into one
container encoded in set-up, each ``length`` frames from 1 to ``max_len``
at a start in [0, frames - length).  Every block of max_len * GOP requests
asks once for each pair of length and start phase within a GOP, in an
order drawn from the seed, so every seed asks for the same lengths and GOP
spans; the start's GOP is uniform among those that keep the request inside
the container.  ``seek_p95_ms`` is the 95th percentile of the latency of
every request in the window.

Besides its timings the loop keeps the frames that ``sample_requests``
requests, drawn from the seed among the first ``sample_from``, returned.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import checks, pool, reference, trace


class Loop:
    phases = ("seek",)

    def __init__(self, codec, traffic: dict, config: dict, seed: int, device,
                 generate) -> None:
        self.codec = codec
        self.profile = codec.profile
        self.frames = traffic["container_frames"]
        self.max_len = traffic["max_len"]
        self.pool = pool.Pool(generate, self.frames, self.frames,
                              config["height"], config["width"], seed, device)
        self.gop = codec.cfg.gop_size
        self.rng = np.random.default_rng([seed, 2])
        self.sample = traffic["sample_requests"]
        self.keep_from = set(np.random.default_rng([seed, 3]).choice(
            traffic["sample_from"], size=self.sample, replace=False).tolist())
        self.records: list[dict] = []
        self.kept: list[tuple[int, int, np.ndarray | None]] = []
        self.failed = 0
        self.data = b""

    def warm_up(self) -> None:
        self.data = self.codec.encode(self.pool.file(0), trace.span).data
        longest = min(self.frames, self.gop // 2 + self.max_len)
        for start, stop in ((0, 1), (self.gop // 2, longest)):
            self.codec.decode_range(self.data, start, stop)

    def window(self, seconds: float, prof: trace.Profiler) -> None:
        deadline = time.perf_counter() + seconds
        k = 0
        requests = self._requests()
        while k == 0 or time.perf_counter() < deadline:
            n, start = next(requests)
            g0, g1 = start // self.gop, -(-(start + n) // self.gop)
            rec = {"start": start, "len": n, "gops": g1 - g0, "latency_s": 0.0}
            out = None
            with prof.op(k):
                try:
                    with trace.span("bench.seek"):
                        t0 = time.perf_counter()
                        out = self.codec.decode_range(self.data, start, start + n)
                        rec["latency_s"] = time.perf_counter() - t0
                except Exception:
                    self.failed += 1
                    pool.failed(f"request {k}", self.failed)
            self.records.append(rec)
            if k in self.keep_from:
                self.kept.append((start, n, out))
            k += 1

    def _requests(self):
        """Endless (length, start) pairs, as the module docstring says."""
        pairs = [(n, phase) for n in range(1, self.max_len + 1) for phase in range(self.gop)]
        while True:
            for k in self.rng.permutation(len(pairs)):
                n, phase = pairs[k]
                top = (self.frames - n - 1 - phase) // self.gop
                yield n, phase + self.gop * int(self.rng.integers(top + 1))

    def attempted(self) -> int:
        return len(self.records)

    def end_to_end(self) -> dict:
        latencies = [r["latency_s"] for r in self.records]
        return {"seek_p95_ms": 1e3 * float(np.percentile(latencies, 95))}

    def check(self, tr: reference.Transform, verdict: checks.Verdict,
              rng: np.random.Generator) -> None:
        """The container's structure and the ints of the GOPs that the kept
        requests cover; each kept request's frames against them."""
        h, w = self.pool.frames.shape[1:]
        reader = checks.ContainerReader(self.data, self.profile, self.frames,
                                        w, h, tr, verdict)
        source = self.pool.file(0)
        for start, n, out in self.kept:
            if out is None or out.shape != (n, h, w) or out.dtype != np.uint8:
                verdict.broke(f"request [{start}, {start + n}) returned no or misshapen frames")
                continue
            g0, g1 = start // self.gop, -(-(start + n) // self.gop)
            ints = [reader.ints(g) for g in range(g0, g1)]
            if any(i is None for i in ints):
                continue
            checks.judge_gop(verdict, tr, source[g0 * self.gop : g1 * self.gop],
                             torch.cat(ints), out, first=start - g0 * self.gop)

    def release(self) -> None:
        self.codec = None
