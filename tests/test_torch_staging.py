"""dct3d_tpu_torch/staging.py on the CPU: what its copies give back, the
reused buffer's growth, and that CPU tensors enter no copy stream and no
transfer stage.  The pinned copies themselves run on the card
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
