"""dct3d_tpu_torch/staging.py on the CPU: what its copies give back, the
reused buffer's growth, that CPU tensors enter no copy stream and no
transfer stage, and the routes of a decode's landing output.  The pinned copies themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from dct3d_tpu_torch import staging
from dct3d_tpu_torch.profiling import StageTimer


def test_fetch_returns_cpu_tensors_arrays():
    """CPU tensors come back as their own arrays (no copy), in order, and
    the timer gets no ``d2h`` stage."""
    tensors = [torch.arange(6, dtype=torch.int32), torch.ones(2, 3, dtype=torch.uint8)]
    timer = StageTimer()
    got = staging.fetch(tensors, timer)
    assert [g.dtype for g in got] == [np.int32, np.uint8]
    for g, t in zip(got, tensors):
        np.testing.assert_array_equal(g, t.numpy())
        assert np.shares_memory(g, t.numpy())
    assert staging.fetch([]) == []
    assert not timer.calls


def test_to_host_async_on_cpu_lands_at_once():
    t = torch.arange(5)
    host, done = staging.to_host_async(t)
    assert host is t and done is None
    np.testing.assert_array_equal(staging.landed((host, done)), t.numpy())


@pytest.mark.parametrize("writeable", [True, False])
def test_to_device_copies_read_only_arrays(writeable):
    """A read-only array (a view of decompressed bytes) is copied into a
    tensor that may be written; a writeable one is taken as it is."""
    arr = np.arange(12, dtype=np.int16).reshape(3, 4)
    arr.flags.writeable = writeable
    t = staging.to_device(arr, torch.device("cpu"))
    assert t.dtype == torch.int16 and t.shape == (3, 4)
    np.testing.assert_array_equal(t.numpy(), arr)
    assert np.shares_memory(t.numpy(), arr) == writeable
    t[0, 0] = 99  # never writes through to a read-only source
    assert arr[0, 0] == (99 if writeable else 0)


def test_host_buffer_grows_and_is_reused():
    """Reads share one buffer of at least 1 MiB; a larger read grows it, and
    the reads after it reuse the grown buffer."""
    buf = staging.HostBuffer()
    rec = torch.tensor([7, 8, 9, 10, 11], dtype=torch.int64)
    assert buf.read(rec, 3).tolist() == [7, 8, 9]
    first = buf._buf
    assert first.numel() == 1 << 20
    small = torch.arange(1000, dtype=torch.int32)
    assert torch.equal(buf.read(small, 1000), small)
    assert buf._buf is first
    big = torch.randint(0, 256, ((1 << 20) + 5,), dtype=torch.uint8)
    assert torch.equal(buf.read(big, big.numel()), big)
    grown = buf._buf
    assert grown is not first and grown.numel() == big.numel()
    assert buf.read(rec, 5).tolist() == rec.tolist()
    assert buf._buf is grown


def test_cpu_enters_no_stream_and_no_stage():
    """``after`` with no stream runs the block as it is, and ``on_card``
    times nothing off the card."""
    timer = StageTimer()
    ran = []
    with staging.after(None, None):
        with staging.on_card(timer, "device_wait", False):
            ran.append(1)
    with staging.on_card(None, "d2h", True):
        ran.append(2)
    with staging.on_card(timer, "d2h", True, 64):
        ran.append(3)
    assert ran == [1, 2, 3]
    assert dict(timer.calls) == {"d2h": 1} and timer.bytes["d2h"] == 64


CARD = torch.device("cuda")  # a device name only: nothing below touches a card


@pytest.mark.parametrize("cap", [0, 4096, staging.LANDING_CAP])
def test_landing_route_by_output_size(monkeypatch, cap):
    """A card's output is pinned at or under the cap and staged above it; a
    CPU output takes the host route at any size.  The default cap holds 517
    1080p frames and not 518."""
    monkeypatch.setattr(staging, "LANDING_CAP", cap)
    assert staging.landing_route(cap, CARD) == "direct"
    assert staging.landing_route(cap + 1, CARD) == "staged"
    assert staging.landing_route(cap + 1, torch.device("cpu")) == "host"
    assert staging.landing_route(0, torch.device("cpu")) == "host"
    assert staging.Landing((2, 3, 4), torch.device("cpu")).route == "host"
    monkeypatch.undo()
    frame = 1920 * 1080
    assert staging.landing_route(517 * frame, CARD) == "direct"
    assert staging.landing_route(518 * frame, CARD) == "staged"


def _gops(n: int, seed: int) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, (8, 6, 10), dtype=np.uint8))
            for _ in range(n)]


@pytest.mark.parametrize("order", ["forward", "reverse", "shuffled"])
def test_landing_host_route_equals_staged_route(monkeypatch, order):
    """The same GOPs put in any order, more than the staging window of them,
    land as the same frames on the host route as on the staged route (a
    card's output above the cap, fed CPU tensors that ``to_host_async``
    passes through), and ``each`` rebuilds every put slice in place."""
    monkeypatch.setattr(staging, "LANDING_CAP", 0)
    gops = _gops(staging._STAGED_WINDOW + 3, seed=5)
    slots = list(range(len(gops)))
    if order == "reverse":
        slots.reverse()
    elif order == "shuffled":
        np.random.default_rng(2).shuffle(slots)
    want = np.concatenate([g.numpy() for g in gops])
    got = {}
    for dev in (torch.device("cpu"), CARD):
        land = staging.Landing(want.shape, dev)
        for k in slots:
            land.put(8 * k, gops[k])
        seen = []

        def bump(frames):
            seen.append(frames.shape[0])
            frames += 1

        got[land.route] = land.result(bump)
        assert seen == [8] * len(gops)
    assert set(got) == {"host", "staged"}
    np.testing.assert_array_equal(got["host"], got["staged"])
    np.testing.assert_array_equal(got["host"], want + np.uint8(1))


def test_landed_counts_gops_by_route(monkeypatch):
    """``LANDED`` counts one GOP a put under its route: a CPU decode's GOPs
    as ``host``, a card-sized output above the cap as ``staged``."""
    from dct3d_tpu_torch import CodecConfig, decode_video, encode_video

    rng = np.random.default_rng(7)
    clip = rng.integers(0, 256, (24, 16, 24), dtype=np.uint8)
    data = encode_video(clip, CodecConfig(), device="cpu")
    staging.LANDED.clear()
    out = decode_video(data, 24, 16, 24, device="cpu")
    assert out.shape == clip.shape
    assert dict(staging.LANDED) == {"host": 3}
    monkeypatch.setattr(staging, "LANDING_CAP", 0)
    land = staging.Landing((16, 6, 10), CARD)
    for k, g in enumerate(_gops(2, seed=1)):
        land.put(8 * k, g)
    land.result()
    assert dict(staging.LANDED) == {"host": 3, "staged": 2}
