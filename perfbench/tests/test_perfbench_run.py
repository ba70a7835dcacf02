"""The harness's command and its result line, run on the CPU at a tiny size."""

import json
import os
import shutil
import subprocess
import textwrap
import sys

import numpy as np
import pytest
import torch

from perfbench import run, spec
from perfbench.tests.tiny import TINY

B = spec.benchmark()
CELLS = [w["name"] for w in B["workloads"]]
CPU = torch.device("cpu")


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("dct3d_tpu_torch.fake", "jaxfake", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.banned_modules() == []
    for name in ("dct3d_tpu.fake", "jaxlib", "flax.core"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.banned_modules() == ["dct3d_tpu.fake", "flax.core", "jaxlib"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_result_object(cell, traced):
    c = spec.Cell(B, cell)
    r = run.run_cell(c, 2**31 + 12345, 0.3, traced, CPU, overrides=TINY)
    assert list(r)[:3] == ["correct", "attempted", "failed"] and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert set(r["metrics"]) <= {m["name"] for m in c.per_layer}
        assert r["device"]["window_s"] > 0
        assert all(len(v) <= 10 for v in r["breakdown"].values())
    else:
        assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
        assert all(m["value"] > 0 for m in r["metrics"].values())
    assert all(set(v) == {"value", "limit"} for v in r["checks"].values())


def test_same_seed_same_content():
    bench_clip, screen = spec.generator("bench_clip"), spec.generator("screen_blocks")
    a = bench_clip(4, 16, 24, 2**31 + 7, CPU)
    b = bench_clip(4, 16, 24, 2**31 + 7, CPU)
    c = screen(4, 64, 64, 2**31 + 7, CPU)
    assert (a == b).all() and (c == screen(4, 64, 64, 2**31 + 7, CPU)).all()
    assert not (a == bench_clip(4, 16, 24, 8, CPU)).all()


def test_a_run_loads_no_jax():
    code = (
        "import sys, torch\n"
        "from perfbench import run, spec\n"
        "from perfbench.tests.tiny import TINY\n"
        "c = spec.Cell(spec.benchmark(), 'ref8.noisy.transcode')\n"
        "r = run.run_cell(c, 5, 0.2, True, torch.device('cpu'), overrides=TINY)\n"
        "print(r['correct'], run.banned_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "True []"


@pytest.mark.parametrize("traced", [False, True])
def test_a_mesh_configuration_needs_only_data(traced):
    """``"mesh": [G, T]`` in a configuration's file routes the cell through
    the sharded encoder and decoder (here two CPU shards): how a four-card
    cell such as ref8.noisy.mesh4 is added with files alone."""
    overrides = {"config": {**TINY["config"], "mesh": [2, 1]}, "traffic": TINY["traffic"]}
    r = run.run_cell(spec.Cell(B, "ref8.noisy.transcode"), 5, 0.3, traced, CPU,
                     overrides=overrides)
    assert r["correct"] and r["failed"] == 0


@pytest.mark.parametrize("name,config,traffic,metric", [
    ("ref8.noisy.seek", "ref-8x8x8-1080p", "noisy.seek", "seek_p95_ms"),
    ("ref8.screen.transcode", "ref-8x8x8-1080p", "screen.transcode", "decode_fps"),
])
def test_cells_left_for_later_run_from_data(name, config, traffic, metric):
    """The seek and screen traffic files, left out of BENCHMARK.json for
    their spread on the card (PERF.md), still make whole, correct runs that
    report the issue's metrics: adding either cell back is entries only."""
    bench = {**B, "workloads": B["workloads"] + [
        {"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "-"}],
        "end_to_end": [{**m, "workloads": m.get("workloads", []) + [name]}
                       if m["name"] == metric else m for m in B["end_to_end"]]
        + ([{"name": "seek_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
             "source": "host_clock", "workloads": [name]}] if "seek" in metric else [])}
    r = run.run_cell(spec.Cell(bench, name), 9, 0.3, False, CPU, overrides=TINY)
    assert r["correct"] and metric in r["metrics"] and r["metrics"][metric]["value"] > 0


LOOP = """
    from perfbench import spec

    Transcode = spec.loop_class("transcode")


    class Loop(Transcode):
        \"\"\"Transcode, also reporting the mean seconds of one file.\"\"\"

        def end_to_end(self):
            recs = self.records
            return {**super().end_to_end(),
                    "file_s": sum(r["encode_s"] + r["decode_s"] for r in recs) / len(recs)}
"""
CONTENT = """
    import numpy as np


    def generate(frames, height, width, seed, device):
        x = np.arange(width)[None, None, :] + np.arange(height)[None, :, None]
        return ((4 * x + np.arange(frames)[:, None, None] + seed) % 256).astype(np.uint8)
"""


def test_a_new_loop_and_content_are_files_only(tmp_path):
    """A traffic mix whose loop and content are new files, dropped beside a
    copy of a configuration, runs as a cell with no edit of any file."""
    pb = tmp_path / "perfbench"
    for sub in ("configs", "traffic", "loops", "content"):
        (pb / sub).mkdir(parents=True)
    (pb / "loops" / "timed_transcode.py").write_text(textwrap.dedent(LOOP))
    (pb / "content" / "ramp.py").write_text(textwrap.dedent(CONTENT))
    entry = B["configs"][0]
    shutil.copy(os.path.join(spec.ROOT, entry["file"]), tmp_path / entry["file"])
    traffic = {**spec.Cell(B, CELLS[0]).traffic, "loop": "timed_transcode", "content": "ramp"}
    (pb / "traffic" / "ramp.transcode.json").write_text(json.dumps(traffic))
    bench = {**B, "workloads": [{"name": "x.ramp", "config": entry["name"],
                                 "traffic": "ramp.transcode", "chips": 1, "why": "-"}],
             "end_to_end": [{"name": n, "unit": "s", "better": "lower", "bound": 0.25,
                             "source": "host_clock"} for n in ("file_s", "setup_s")]}
    r = run.run_cell(spec.Cell(bench, "x.ramp", root=str(tmp_path)), 3, 0.3, False, CPU,
                     overrides=TINY)
    assert r["correct"] and set(r["metrics"]) == {"file_s", "setup_s"}


def test_transcode_checks_every_gop_position():
    """The files checked keep, between them, every GOP position of a file:
    the first, the last of each push of four GOPs, the last of the file."""
    c = spec.Cell(B, "ref8.noisy.transcode")
    sample, gops = c.traffic["sample_gops"], c.traffic["frames_per_file"] // 8
    for seed in (1, 2**31 + 5):
        kept = [(i + seed) % gops for i in range(37)]
        picks = spec.loop_class("transcode").picks(kept, sample, np.random.default_rng(seed))
        assert sorted(kept[k] for k in picks) == list(range(gops))
