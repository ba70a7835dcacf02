"""Every copy between the host and a card, and the pinned memory it goes
through: the encoders' and decoders' uploads and readbacks, the whole-output
decodes' landing (``Landing``), the drains' copy streams and transfer
stages, and the DEFLATE driver's reused buffer (ops/deflate.Deflater).  CPU
tensors take no pinned memory, no stream and no stage: ``fetch`` gives back
their arrays."""

from __future__ import annotations

import collections
import contextlib
import math
import threading

import numpy as np
import torch

_OFF = contextlib.nullcontext()

#: The largest output, in bytes, that a ``Landing`` pins: 1 GiB, 517 frames
#: of 1080p.  Torch's caching host allocator rounds a pinned block up to a
#: power of two and keeps it for the life of the process, so a longer
#: video's output lands through staging copies into pageable memory rather
#: than pinning up to twice its size for good.
LANDING_CAP = 1 << 30

#: GOPs whose staging copies are in flight before the oldest is landed
_STAGED_WINDOW = 4

#: GOPs landed by a ``Landing``, by route, process-wide: ``"direct"``
#: (straight into the pinned output), ``"staged"`` (through a pinned staging
#: copy into a pageable output) and ``"host"`` (CPU tensors, copied in).
LANDED: collections.Counter = collections.Counter()
_landed_lock = threading.Lock()


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


def landing_route(nbytes: int, device: torch.device) -> str:
    """The route a ``Landing`` of ``nbytes`` on ``device`` takes (see
    ``LANDED``): pinned up to ``LANDING_CAP``, staged above it."""
    if device.type != "cuda":
        return "host"
    return "direct" if nbytes <= LANDING_CAP else "staged"


class Landing:
    """The (T, H, W) uint8 output of one whole decode, into which each GOP's
    frames land at their frame offset.

    Up to ``LANDING_CAP`` bytes of a card's frames the output is pinned,
    from torch's caching host allocator: each GOP's D2H copy goes straight
    into its slice on the current stream, with no host copy and no fresh
    pages, and ``result`` waits once, on the last copy's event.  A GOP's
    device frames may be dropped once put: the caching allocator reuses
    their memory in stream order, after the copy.  The array
    it returns keeps the block alive (its ``base``); the allocator hands the
    block to a later output only once that array is gone.  Above the cap
    each GOP goes through ``to_host_async`` into staging and is copied into
    a pageable output, ``_STAGED_WINDOW`` GOPs in flight; CPU tensors are
    copied in the same way."""

    def __init__(self, shape, device) -> None:
        self.route = landing_route(math.prod(shape), torch.device(device))
        if self.route == "direct":
            self._pinned = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
            self.out = self._pinned.numpy()
        else:
            self.out = np.empty(shape, np.uint8)
        self._spans: list[tuple[int, int]] = []
        self._staged: collections.deque = collections.deque()
        self._done = None

    def put(self, a0: int, frames: torch.Tensor) -> None:
        """Start landing ``frames`` in ``out[a0 : a0 + len(frames)]``."""
        n = frames.shape[0]
        self._spans.append((a0, n))
        with _landed_lock:
            LANDED[self.route] += 1
        if self.route == "direct":
            self._pinned[a0 : a0 + n].copy_(frames, non_blocking=True)
            self._done = mark(frames.device)
            return
        self._staged.append((a0, to_host_async(frames)))
        if len(self._staged) >= _STAGED_WINDOW:
            self._land_oldest()

    def _land_oldest(self) -> None:
        a0, started = self._staged.popleft()
        host = landed(started)
        self.out[a0 : a0 + host.shape[0]] = host

    def result(self, each=None) -> np.ndarray:
        """The output once every copy has landed; ``each``, if given, then
        runs on the slice of every ``put``, in order, to change it in place."""
        if self._done is not None:
            self._done.synchronize()
        while self._staged:
            self._land_oldest()
        if each is not None:
            for a0, n in self._spans:
                each(self.out[a0 : a0 + n])
        return self.out


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
