"""The port's spans and stage timers (dct3d_tpu_torch/profiling.py): the
guard that keeps spans free while nothing traces, ``profile_to``'s trace
of every thread, and the StageTimer stages of the encoders and the DEFLATE
sinks.  CPU only."""

import json
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from dct3d_tpu_torch import (
    CodecConfig, StreamingEncoder, TransformContext, TurboEncoder, cli, decode_auto, profiling,
)
from dct3d_tpu_torch.codec import entropy
from dct3d_tpu_torch.parallel.mesh import make_mesh
from dct3d_tpu_torch.parallel.multihost import MEMBER_MAGIC, MEMBER_TEMPORAL, make_index_member
from dct3d_tpu_torch.parallel.sharding import ShardedEncoder

W, H, T = 64, 48, 24
GOPS = T // 8
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def clip():
    """A gradient XOR small noise (the bench clip's recipe): every GOP stays
    a turbo member, and the reference stream has several KB a GOP."""
    t, y, x = np.ogrid[:T, :H, :W]
    noise = np.random.default_rng(14).integers(0, 16, (T, H, W))
    return ((2 * x + 3 * y + 4 * t) % 256 ^ noise).astype(np.uint8)


def _ranges(path):
    """(name, tid, start, end) of every record_function range in a trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and "dur" in e]


def _traced(tmp_path, fn):
    """Run ``fn`` inside ``profile_to`` and a ``test.call`` range; return
    (that range, every other range)."""
    with profiling.profile_to(str(tmp_path)):
        with profiling.trace("test.call"):
            fn()
    ranges = _ranges(tmp_path / "trace.json")
    (outer,) = [r for r in ranges if r[0] == "test.call"]
    return outer, [r for r in ranges if r[0] != "test.call"]


def _container(enc, stream):
    """The indexed container ``encode`` writes around a finished stream."""
    head = MEMBER_MAGIC + struct.pack("<IQ", (MEMBER_TEMPORAL << 24) | enc.frames_encoded,
                                      len(stream))
    return head + stream + make_index_member(enc.gop_bit_ends, sync_offsets=enc.gop_sync_offsets)


class _Counting:
    """Stands in for torch.profiler.record_function and counts entries by
    thread, delegating to the real one."""

    def __init__(self, real):
        self.real, self.threads = real, []

    def __call__(self, name):
        self.threads.append(threading.get_ident())
        return self.real(name)


def test_trace_enters_record_function_only_while_a_profiler_runs(monkeypatch):
    counting = _Counting(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with profiling.trace("idle"):
        pass
    assert counting.threads == []

    def worker():
        with profiling.trace("on.worker"):
            pass
        # The per-thread flag misses a profile started on another thread;
        # the guard's process-wide flag does not.
        return torch._C._autograd._profiler_enabled(), threading.get_ident()

    with ThreadPoolExecutor(1) as pool:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            per_thread_flag, tid = pool.submit(worker).result(timeout=60)
    assert per_thread_flag is False
    assert counting.threads == [tid] and tid != threading.get_ident()
    with profiling.trace("after"):
        pass
    assert counting.threads == [tid]


def test_profile_to_records_every_thread_on_one_clock(clip, tmp_path):
    """A small reference encode with two DEFLATE workers and blocks small
    enough that each GOP gives several: ``deflate`` on at least two pool
    threads, the calling thread's spans on the caller, every worker range
    inside the caller's range around the encode (the same ``ts`` clock)."""
    cfg = CodecConfig(deflate_workers=2)
    ctx = TransformContext(cfg, CPU)

    def encode():
        enc = StreamingEncoder(W, H, cfg, ctx)
        enc.sink = entropy.ParallelDeflateSink(cfg.zlib_level, 2, block_size=2048,
                                               timer=enc.timer)
        enc.push(clip)
        enc.finish()

    (_, caller, t0, t1), ranges = _traced(tmp_path, encode)
    on_caller = {name for name, tid, _, _ in ranges if tid == caller}
    assert {"dispatch", "stage_in", "wait_drainer", "wait_deflate"} <= on_caller
    deflate_threads = {tid for name, tid, _, _ in ranges if name == "deflate"}
    assert len(deflate_threads - {caller}) >= 2
    drainer = {name for name, tid, _, _ in ranges if tid not in deflate_threads | {caller}}
    assert {"sink_push"} <= drainer
    workers = [r for r in ranges if r[1] != caller]
    assert workers and all(t0 <= a and b <= t1 for _, _, a, b in workers)


def test_decode_spans_on_caller_and_pools(clip, tmp_path):
    """An indexed container's decode: inflate, entropy_wait, dispatch,
    stage_in and readback on the calling thread; inflate per sync span and
    entropy per chunk on the pools."""
    cfg = CodecConfig(deflate_workers=2)
    ctx = TransformContext(cfg, CPU)
    enc = StreamingEncoder(W, H, cfg, ctx)
    data = _container(enc, enc.push(clip) + enc.finish())
    out = {}
    (_, caller, _, _), ranges = _traced(
        tmp_path, lambda: out.update(frames=decode_auto(data, W, H, cfg=cfg, ctx=ctx)))
    assert out["frames"].shape == clip.shape
    on_caller = [name for name, tid, _, _ in ranges if tid == caller]
    for name in ("dispatch", "stage_in"):
        assert on_caller.count(name) == GOPS, name
    # One wait a GOP, and the last, which finds the chunks' end; one
    # readback a GOP's copy, and the wait for the whole output.
    assert on_caller.count("entropy_wait") == on_caller.count("readback") == GOPS + 1
    assert on_caller.count("inflate") == 1
    on_workers = [name for name, tid, _, _ in ranges if tid != caller]
    assert on_workers.count("inflate") == GOPS and on_workers.count("entropy") >= 1


def test_turbo_spans_on_caller_and_workers(clip, tmp_path):
    cfg = CodecConfig(deflate_workers=2, turbo_codec="zlib")
    ctx = TransformContext(cfg, CPU)
    out = {}

    def encode_decode():
        enc = TurboEncoder(W, H, cfg, ctx)
        out["data"] = enc.push(clip) + enc.finish()
        out["frames"] = decode_auto(out["data"], W, H, cfg=cfg, ctx=ctx)

    (_, caller, _, _), ranges = _traced(tmp_path, encode_decode)
    assert out["frames"].shape == clip.shape
    on_caller = [name for name, tid, _, _ in ranges if tid == caller]
    assert on_caller.count("stage_in") == 2 * GOPS  # encode and decode
    assert on_caller.count("entropy_wait") == GOPS
    assert on_caller.count("readback") == GOPS + 1  # a GOP's copy each, the output's wait
    assert "wait_drainer" in on_caller
    on_workers = [name for name, tid, _, _ in ranges if tid != caller]
    assert on_workers.count("member") == on_workers.count("parse") == GOPS


def _deflate_input(stream: bytes) -> int:
    return len(zlib.decompress(stream))


@pytest.mark.parametrize("workers", [0, 2])
def test_stage_timer_of_both_sinks(clip, workers):
    """sink_push: one call a GOP, the drainer's hand-off to the sink;
    deflate: one call a compressed block (a GOP's chunk, then the final
    byte), with the bytes the stream inflates back to."""
    cfg = CodecConfig(deflate_workers=workers)
    enc = StreamingEncoder(W, H, cfg, TransformContext(cfg, CPU))
    assert isinstance(enc.sink, entropy.DeflateSink if workers == 0
                      else entropy.ParallelDeflateSink)
    assert enc.sink.timer is enc.timer
    stream = enc.push(clip) + enc.finish()
    stats = enc.timer.as_dict()
    assert stats["sink_push"]["calls"] == GOPS
    assert stats["deflate"]["calls"] == GOPS + 1
    assert stats["deflate"]["bytes"] == _deflate_input(stream)
    assert stats["dispatch"]["calls"] == stats["stage_in"]["calls"] == GOPS
    assert stats["stage_in"]["bytes"] == clip.nbytes


def test_parallel_sink_times_each_block():
    """Blocks of a chunk larger than the block size each get a stage."""
    timer = profiling.StageTimer()
    sink = entropy.ParallelDeflateSink(6, 2, block_size=1000, timer=timer)
    payload = np.random.default_rng(3).integers(0, 4, 4500, dtype=np.uint8)
    stream = sink.push_packed(payload, 8 * payload.size) + sink.finish()
    sink.close()
    assert timer.calls["deflate"] == 5 + 1 and timer.bytes["deflate"] == 4501
    assert zlib.decompress(stream)[:-1] == payload.tobytes()


def test_turbo_encoder_timer(clip):
    cfg = CodecConfig(deflate_workers=2, turbo_codec="zlib")
    enc = TurboEncoder(W, H, cfg, TransformContext(cfg, CPU))
    enc.push(clip)
    enc.finish()
    stats = enc.timer.as_dict()
    assert {k: stats[k]["calls"] for k in ("dispatch", "stage_in", "member")} == dict.fromkeys(
        ("dispatch", "stage_in", "member"), GOPS)
    assert stats["stage_in"]["bytes"] == clip.nbytes and stats["member"]["bytes"] > 0


def test_sharded_encoder_timer(clip):
    cfg = CodecConfig(deflate_workers=2)
    enc = ShardedEncoder(W, H, make_mesh(gop=2, tile=1, devices=[CPU] * 2), cfg)
    frames = clip[:16]
    stream = enc.push(frames) + enc.finish()
    stats = enc.timer.as_dict()
    assert {k: stats[k]["calls"] for k in ("dispatch", "stage_in", "sink_push")} == dict.fromkeys(
        ("dispatch", "stage_in", "sink_push"), 1)
    assert stats["stage_in"]["bytes"] == frames.nbytes
    assert stats["deflate"]["calls"] == 2 and stats["deflate"]["bytes"] == _deflate_input(stream)


@pytest.mark.parametrize("flags,stages", [
    (["--mesh", "2x1"], {"dispatch", "stage_in", "sink_push", "deflate"}),
    (["--turbo"], {"dispatch", "stage_in", "member"}),
])
def test_cli_stats_print_for_mesh_and_turbo(clip, tmp_path, capsys, flags, stages):
    src, out = tmp_path / "src.raw", tmp_path / "out.bin"
    clip[:16].tofile(src)
    assert cli.main(["encode", str(src), str(out), str(W), str(H), "--stats", *flags,
                     "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert stages <= set(stats)
