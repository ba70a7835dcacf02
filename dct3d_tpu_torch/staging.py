"""Every copy between the host and a card, and the pinned memory it goes
through: the encoders' and decoders' uploads and readbacks, the drains'
copy streams and transfer stages, and the DEFLATE driver's reused buffer
(ops/deflate.Deflater).  CPU tensors take no pinned memory, no stream and
no stage: ``fetch`` gives back their arrays."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

_OFF = contextlib.nullcontext()


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``; to a card through pinned memory
    with a non-blocking copy on the current stream.  Read-only arrays (views
    of decompressed bytes) are copied, never aliased."""
    arr = np.ascontiguousarray(arr)
    if device.type == "cuda":
        host = torch.empty(arr.shape, dtype=getattr(torch, arr.dtype.name),
                           pin_memory=True)
        host.numpy()[...] = arr
        return host.to(device, non_blocking=True)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def mark(device: torch.device) -> torch.cuda.Event | None:
    """An event recorded on ``device``'s current stream (None off a card):
    what ``after`` and ``landed`` wait for."""
    if device.type != "cuda":
        return None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return done


def to_host_async(t: torch.Tensor):
    """Start a device->host copy into fresh pinned memory on the current
    stream; returns (host tensor, event or None).  A CPU tensor comes back
    as it is."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host, mark(t.device)


def landed(started) -> np.ndarray:
    """The host array of a copy ``to_host_async`` started, once it is done."""
    host, done = started
    if done is not None:
        done.synchronize()
    return host.numpy()


def fetch(tensors, timer=None) -> list[np.ndarray]:
    """Tensors -> host arrays: every copy started at once, then each waited
    for.  ``timer`` (a StageTimer) gets a ``d2h`` stage of the bytes copied
    when the tensors are on a card."""
    tensors = list(tensors)
    with on_card(timer, "d2h", any(t.is_cuda for t in tensors),
                 sum(t.nbytes for t in tensors)):
        return [landed(s) for s in [to_host_async(t) for t in tensors]]


def on_card(timer, name: str, card: bool, nbytes: int = 0):
    """``timer.stage(name, nbytes)`` when ``card``, else a no-op: the
    transfer stages (``device_wait``, ``d2h``) count only a card's."""
    return timer.stage(name, nbytes) if timer is not None and card else _OFF


@contextlib.contextmanager
def after(done, stream):
    """Run the block on a drain's own ``stream`` once the device reaches the
    producer's event ``done`` (the current stream is per thread in torch);
    a no-op when ``stream`` is None (the CPU)."""
    if stream is None:
        yield
        return
    with torch.cuda.stream(stream):
        stream.wait_event(done)
        yield


class HostBuffer:
    """One host buffer, grown to the largest read (at least 1 MiB) and
    reused by every read after it; pinned when the read that allocates it
    comes from a card."""

    def __init__(self) -> None:
        self._buf: torch.Tensor | None = None

    def read(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """The first ``n`` elements of ``t``, copied into the buffer on the
        current stream and waited for: a view the next read overwrites."""
        nbytes = n * t.element_size()
        if self._buf is None or self._buf.numel() < nbytes:
            self._buf = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8,
                                    pin_memory=t.is_cuda)
        host = self._buf[:nbytes].view(t.dtype)
        host.copy_(t[:n], non_blocking=t.is_cuda)
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
        return host
