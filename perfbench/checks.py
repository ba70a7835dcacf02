"""The comparison that decides ``correct``.

Three numbers, each with its limit in ``LIMITS``:

  int_gap     over the sampled GOPs, the widest distance, in quantizer
              steps, by which the float64 quantizer input of an int the
              program wrote lies outside the interval that rounds to that
              int.  0 where the ints agree; a float32 rounding that tips an
              int at a tie reads a few 1e-5; a wrong int reads 0.5 or more
              on most coefficients.
  pixel_gap   over the sampled decoded frames, the same distance, in pixel
              levels, of the float64 inverse transform of the ints in the
              container from the interval that truncates to the pixel the
              program returned.
  structure   count of broken promises of the container: member types and
              frame counts, the index's GOP count and bit ends, streams
              that do not inflate or parse, shapes of what a call returned.
              Exact: its limit is 0.

The readings each limit was set from are in PERF.md ("Correctness").
"""

from __future__ import annotations

import math
import struct

import torch

from . import reference

LIMITS = {"int_gap": 0.05, "pixel_gap": 0.02, "structure": 0}


def int_gap(ints: torch.Tensor, scaled: torch.Tensor, bias: float) -> float:
    """Widest distance of ``scaled`` from the preimage of ``ints`` under
    sign(x) * floor(|x| + bias)."""
    p = ints.to(torch.float64)
    lo = torch.where(p > 0, p - bias, torch.where(p < 0, p - 1 + bias, bias - 1))
    hi = torch.where(p > 0, p + 1 - bias, torch.where(p < 0, p + bias, 1 - bias))
    gap = (lo - scaled).clamp(min=0) + (scaled - hi).clamp(min=0)
    return float(gap.max()) if gap.numel() else 0.0


def pixel_gap(pixels: torch.Tensor, unscaled: torch.Tensor) -> float:
    """Widest distance of ``unscaled`` from the preimage of ``pixels`` under
    clamp to [0, 255] and truncation."""
    p = pixels.to(torch.float64)
    lo = torch.where(p == 0, -math.inf, p)
    hi = torch.where(p == 255, math.inf, p + 1)
    gap = (lo - unscaled).clamp(min=0) + (unscaled - hi).clamp(min=0)
    return float(gap.max()) if gap.numel() else 0.0


class Verdict:
    """Accumulates the numbers of one run and the promises it found broken."""

    def __init__(self) -> None:
        self.numbers = {"int_gap": 0.0, "pixel_gap": 0.0, "structure": 0}
        self.broken: list[str] = []
        self.judged = 0
        self.psnr: list[float] = []  # dB of the sampled decoded GOPs, for the record

    def broke(self, what: str) -> None:
        self.numbers["structure"] += 1
        if len(self.broken) < 20:
            self.broken.append(what)

    def gap(self, name: str, value: float) -> None:
        self.numbers[name] = max(self.numbers[name], value)

    def passed(self) -> bool:
        return all(self.numbers[k] <= LIMITS[k] for k in LIMITS)

    def as_dict(self) -> dict:
        return {k: {"value": self.numbers[k], "limit": LIMITS[k]} for k in LIMITS}


def judge_gop(v: Verdict, tr: reference.Transform, source,
              ints: torch.Tensor, decoded=None, first: int = 0) -> None:
    """GOPs in a row: the container's ``ints`` (cubes, cube) against the
    float64 quantizer of the ``source`` frames (numpy, whole GOPs), and the
    program's ``decoded`` frames, which start ``first`` frames into those
    GOPs, against the float64 inverse transform of the ints.  Either side
    may be None."""
    ints = ints.to(tr.device)
    if source is not None:
        v.gap("int_gap", int_gap(ints, tr.scaled(source), tr.bias))
    if decoded is not None:
        t = ints.shape[0] * ints.shape[1] // (decoded.shape[1] * decoded.shape[2])
        x = tr.frames(tr.unscaled(ints), t, *decoded.shape[1:])
        dec = torch.from_numpy(decoded).to(tr.device)
        v.gap("pixel_gap", pixel_gap(dec, x[first : first + dec.shape[0]]))
    v.judged += 1


class ContainerReader:
    """Reads the ints of any GOP of one container the way the reference
    understands the format, recording what breaks in ``verdict``."""

    def __init__(self, data: bytes, profile: str, frames: int, width: int,
                 height: int, tr: reference.Transform, verdict: Verdict) -> None:
        bw, bh, bd = tr.block
        self.tr, self.v, self.profile = tr, verdict, profile
        self.cubes = (width // bw) * (height // bh)
        self.cube = bw * bh * bd
        self.gops = frames // bd
        self._raw = None
        self._ints: dict[int, torch.Tensor | None] = {}
        self.members = []
        try:
            self.members = reference.split_members(data)
        except ValueError as e:
            verdict.broke(f"container: {e}")
            return
        if profile == "turbo":
            kinds = [m[0] for m in self.members]
            if len(kinds) != self.gops or set(kinds) - {reference.TURBO, reference.TEMPORAL}:
                verdict.broke(f"turbo container has member types {kinds}, "
                              f"want {self.gops} GOP members")
            elif any(m[1] != bd for m in self.members):
                verdict.broke("turbo member frame counts are not one GOP each")
            return
        kinds = [m[0] for m in self.members]
        if kinds != [reference.TEMPORAL, reference.INDEX]:
            verdict.broke(f"container has member types {kinds}, want [0, 4]")
            return
        if self.members[0][1] != frames:
            verdict.broke(f"stream member says {self.members[0][1]} frames, want {frames}")
        try:
            self.ends, syncs = reference.parse_index(self.members[1][2])
        except (ValueError, struct.error) as e:
            verdict.broke(f"index: {e}")
            self.members = []
            return
        if len(self.ends) != self.gops or any(
                b <= a for a, b in zip([0] + self.ends, self.ends)):
            verdict.broke(f"index holds {len(self.ends)} bit ends, not "
                          f"{self.gops} increasing ones")
            self.members = []
        elif syncs is None:
            verdict.broke("index has no sync offsets (parallel inflate)")

    def ints(self, g: int) -> torch.Tensor | None:
        """GOP g's (cubes, cube) ints, or None when they cannot be read."""
        if g not in self._ints:
            self._ints[g] = self._read(g)
        return self._ints[g]

    def _read(self, g: int) -> torch.Tensor | None:
        if not self.members:
            return None
        try:
            if self.profile == "turbo":
                kind, _, payload = self.members[g]
                if kind == reference.TURBO:
                    return reference.turbo_ints(payload, self.cubes, self.cube)
                raw = reference.inflate(payload)
                values, _ = reference.eg_decode(raw, 0, self.cubes * self.cube,
                                                8 * len(raw), self.tr.device)
                return values.reshape(self.cubes, self.cube)
            if self._raw is None:
                self._raw = reference.inflate(self.members[0][2])
            start = self.ends[g - 1] if g else 0
            values, end = reference.eg_decode(
                self._raw, start, self.cubes * self.cube, self.ends[g] + 64,
                self.tr.device)
            if end != self.ends[g]:
                self.v.broke(f"GOP {g} ends at bit {end}, the index says {self.ends[g]}")
            return values.reshape(self.cubes, self.cube)
        except ValueError as e:
            self.v.broke(f"GOP {g}: {e}")
            return None

