"""``transcode``: a closed loop of one client over whole files, each encoded
and then decoded from the container it produced; file ``i`` of the window
is ``Pool.file(i + 1)`` (file 0 warms up).

Besides its timings the loop keeps what the check after the window needs:
every container, and the decoded frames of one GOP of each file.  File
``i`` keeps GOP ``(i + offset) % gops``, the offset drawn from the seed
before the window opens, so every position in a file (the first GOP, the
last GOP of each push, the last of the file) is kept in some files.
"""

from __future__ import annotations

import time

import numpy as np

from perfbench import checks, pool, quality, reference, trace


class Loop:
    phases = ("encode", "decode")

    def __init__(self, codec, traffic: dict, config: dict, seed: int, device,
                 generate) -> None:
        self.codec = codec
        self.profile = codec.profile
        self.fpf = traffic["frames_per_file"]
        self.pool = pool.Pool(generate, traffic["pool_frames"], self.fpf,
                              config["height"], config["width"], seed, device)
        self.gop = codec.cfg.gop_size
        self.gops = self.fpf // self.gop
        self.offset = int(np.random.default_rng([seed, 1]).integers(self.gops))
        self.sample = traffic["sample_gops"]
        self.records: list[dict] = []
        self.failed = 0

    def warm_up(self) -> None:
        enc = self.codec.encode(self.pool.file(0), trace.span)
        self.codec.decode(enc.data)

    def window(self, seconds: float, prof: trace.Profiler) -> None:
        deadline = time.perf_counter() + seconds
        i = 0
        while i == 0 or time.perf_counter() < deadline:
            frames = self.pool.file(i + 1)
            g = (i + self.offset) % self.gops
            rec = {"frames": self.fpf, "gops": self.gops, "encode_s": 0.0,
                   "decode_s": 0.0, "bytes": 0, "data": b"", "gop": g, "decoded": None}
            with prof.op(i):
                try:
                    with trace.span("bench.encode"):
                        t0 = time.perf_counter()
                        enc = self.codec.encode(frames, trace.span)
                        rec["encode_s"] = time.perf_counter() - t0
                    rec.update(data=enc.data, bytes=len(enc.data), timer=enc.timer,
                               finish_s=enc.finish_s)
                    with trace.span("bench.decode"):
                        t0 = time.perf_counter()
                        out = self.codec.decode(enc.data)
                        rec["decode_s"] = time.perf_counter() - t0
                    if out.shape == frames.shape and out.dtype == np.uint8:
                        rec["decoded"] = out[g * self.gop : (g + 1) * self.gop].copy()
                    del out
                except Exception:  # a failed call counts; the window runs on
                    self.failed += 1
                    pool.failed(f"file {i}", self.failed)
            self.records.append(rec)
            i += 1

    def attempted(self) -> int:
        return 2 * len(self.records)

    def end_to_end(self) -> dict:
        recs = self.records
        frames = sum(r["frames"] for r in recs)
        h, w = self.pool.frames.shape[1:]
        return {
            "encode_fps": frames / sum(r["encode_s"] for r in recs),
            "decode_fps": frames / sum(r["decode_s"] for r in recs),
            "bpp": quality.bits_per_pixel(sum(r["bytes"] for r in recs), w, h, frames),
        }

    @staticmethod
    def picks(kept: list[int], sample: int, rng: np.random.Generator) -> list[int]:
        """Files to check, given the GOP that each file kept: for each GOP
        position, one of the files that kept it, drawn from ``rng``; at most
        ``sample`` of them."""
        by_gop: dict[int, list[int]] = {}
        for k, g in enumerate(kept):
            by_gop.setdefault(g, []).append(k)
        picks = [int(rng.choice(ks)) for _, ks in sorted(by_gop.items())]
        if len(picks) > sample:
            picks = sorted(rng.choice(picks, size=sample, replace=False).tolist())
        return picks

    def check(self, tr: reference.Transform, verdict: checks.Verdict,
              rng: np.random.Generator) -> None:
        """Every container's structure; the ints and pixels of the kept GOP
        of each picked file."""
        h, w = self.pool.frames.shape[1:]
        readers = [checks.ContainerReader(r["data"], self.profile, self.fpf, w, h, tr, verdict)
                   for r in self.records]
        for k in self.picks([r["gop"] for r in self.records], self.sample, rng):
            g, decoded = self.records[k]["gop"], self.records[k]["decoded"]
            if decoded is None:
                verdict.broke(f"file {k}: no decoded frames to compare")
                continue
            ints = readers[k].ints(g)
            if ints is not None:
                src = self.pool.file(k + 1)[g * self.gop : (g + 1) * self.gop]
                checks.judge_gop(verdict, tr, src, ints, decoded)
                verdict.psnr.append(quality.psnr(src, decoded))

    def release(self) -> None:
        self.codec = None
