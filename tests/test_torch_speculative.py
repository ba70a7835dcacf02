"""The port's speculative decode (entropy.speculative_planar4_chunks,
speculative_positions, the pair decoder and parallel_chunks' routes)
against the JAX package's, on the cases of tests/test_speculative.py.

Both packages' functions decode the same seeded streams; their chunk
tuples (plane, exception indices and values, end bit) and positions must be
byte-equal to each other and to the serial planar4 decoder's.  _SPEC_MIN_SEG
is patched down in both modules so small payloads engage the path.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import synthetic_video
from dct3d_tpu.codec import entropy as j_entropy
from dct3d_tpu_torch import CodecConfig, TransformContext, decode_frame_range, decode_video
from dct3d_tpu_torch import encode_video, native
from dct3d_tpu_torch.codec import entropy

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _small_segments(monkeypatch):
    for mod in (entropy, j_entropy):
        monkeypatch.setattr(mod, "_SPEC_MIN_SEG", 4096)


def _serial(buf, n_chunks, V):
    out, pos = [], 0
    for _ in range(n_chunks):
        plane, ei, ev, pos = entropy.decode_values_planar4(buf, V, pos)
        out.append((plane.copy(), ei.copy(), ev.copy(), pos))
    return out


def _assert_matches(got, ref):
    got = list(got)
    assert len(got) == len(ref)
    for k, ((p, ei, ev, e), (rp, rei, rev, re_)) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(p, rp, err_msg=f"chunk {k} plane")
        np.testing.assert_array_equal(ei, rei, err_msg=f"chunk {k} exc_idx")
        np.testing.assert_array_equal(ev, rev, err_msg=f"chunk {k} exc_val")
        assert e == re_, f"chunk {k} end bit {e} != {re_}"


def _stream(vals):
    payload, _ = entropy.encode_values(np.asarray(vals, np.int32))
    return np.frombuffer(payload + b"\x00", np.uint8)  # the final extra byte


def _bursts(rng, n):
    v = rng.integers(-2, 3, n).astype(np.int32)
    for s in range(0, n, n // 7):
        v[s : s + 48] = 2**24  # ~25 leading zero bits per codeword
    return v


CASES = {
    "mixed": lambda rng, n: np.where(
        rng.random(n) < 0.01, rng.integers(-30000, 30000, n), rng.integers(-3, 4, n),
    ).astype(np.int32),
    "all_wide": lambda rng, n: (
        rng.integers(500, 2000, n) * rng.choice([-1, 1], n)).astype(np.int32),
    "very_wide": lambda rng, n: rng.integers(10**6, 2 * 10**6, n).astype(np.int32),
    "all_zero": lambda rng, n: np.zeros(n, np.int32),
    "zero_run_bursts": _bursts,
}


def _both(buf, V, n_chunks, workers):
    """The port's and the JAX package's fused decode of the same buffer."""
    got = entropy.speculative_planar4_chunks(buf, V, n_chunks, workers=workers)
    want = j_entropy.speculative_planar4_chunks(buf, V, n_chunks, workers=workers)
    assert (got is None) == (want is None)
    return got, want


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n_chunks,V", [(5, 30000), (3, 40002)])
def test_fused_matches_jax_and_serial(name, n_chunks, V):
    rng = np.random.default_rng(sum(map(ord, name)))
    buf = _stream(CASES[name](rng, n_chunks * V))
    got, want = _both(buf, V, n_chunks, 4)
    assert got is not None, "the fused decode did not engage"
    ref = _serial(buf, n_chunks, V)
    _assert_matches(got, ref)
    _assert_matches(want, ref)
    spec = entropy.speculative_positions(buf, V, n_chunks, workers=4)
    assert spec == j_entropy.speculative_positions(buf, V, n_chunks, workers=4)
    # None where a catch-up scan runs out of data (never-converging walks):
    # the serial scan then owns the positions.
    assert spec in (None, [0] + [r[3] for r in ref[:-1]])
    assert spec is not None or name == "very_wide"


def test_fused_long_stream_views():
    """Many chunks against few segments: most chunks are views of the
    segment planes."""
    rng = np.random.default_rng(21)
    n_chunks, V = 40, 5000
    v = rng.integers(-4, 5, n_chunks * V).astype(np.int32)
    p = rng.choice(v.size, v.size // 300, replace=False)
    v[p] = rng.integers(-5000, 5000, p.size)
    buf = _stream(v)
    got, want = _both(buf, V, n_chunks, 4)
    assert got is not None
    ref = _serial(buf, n_chunks, V)
    _assert_matches(got, ref)
    _assert_matches(want, ref)


def test_fused_refuses_truncated_stream():
    v = np.random.default_rng(3).integers(-3, 4, 200000).astype(np.int32)
    buf = _stream(v)[:-500]
    assert _both(buf, 50000, 4, 4) == (None, None)
    # The chunk starts all lie before the cut, so the scan still finds
    # them; the decode of the last chunk owns the EOF.
    assert entropy.speculative_positions(buf, 50000, 4, workers=4) == \
        j_entropy.speculative_positions(buf, 50000, 4, workers=4)
    with pytest.raises(EOFError):
        _serial(buf, 4, 50000)
    with pytest.raises(EOFError):
        list(entropy.parallel_chunks(buf, 50000, 4, entropy.decode_values_planar4))


def test_fused_ignores_stream_tail():
    v = np.random.default_rng(4).integers(-3, 4, 250000).astype(np.int32)
    buf = _stream(v)
    got, want = _both(buf, 50000, 3, 4)
    ref = _serial(buf, 3, 50000)
    _assert_matches(got, ref)
    _assert_matches(want, ref)


@pytest.mark.parametrize("route", ["fused", "positions", "serial", "index", "index_wide"])
def test_parallel_chunks_routes(monkeypatch, route):
    """positions=None takes the fused decode; without it the speculative
    positions; without those the serial scan-ahead; with positions the
    pair decoder, when there are two chunks for every worker, and single
    chunks otherwise (index_wide: 5 chunks, 4 workers).  Every route
    yields the serial decoder's tuples, and the JAX package's
    parallel_chunks yields the same."""
    rng = np.random.default_rng(5)
    n_chunks, V = 5, 60000
    buf = _stream(rng.integers(-5, 6, n_chunks * V).astype(np.int32))
    ref = _serial(buf, n_chunks, V)
    called = []
    for name in ("speculative_planar4_chunks", "speculative_positions",
                 "decode_values_planar4_pair"):
        orig = getattr(entropy, name)

        def spy(*a, _orig=orig, _name=name, **k):
            r = _orig(*a, **k)
            called.append((_name, r is not None))
            return r
        monkeypatch.setattr(entropy, name, spy)
    if route in ("positions", "serial"):
        monkeypatch.setattr(entropy, "speculative_planar4_chunks", lambda *a, **k: None)
    if route == "serial":
        monkeypatch.setattr(entropy, "speculative_positions", lambda *a, **k: None)
    positions = [0] + [r[3] for r in ref[:-1]] if route == "index" else None
    if route == "index_wide":
        positions = [0] + [r[3] for r in ref[:-1]]
    workers = 4 if route == "index_wide" else 2
    got = list(entropy.parallel_chunks(buf, V, n_chunks, entropy.decode_values_planar4,
                                       workers, positions=positions))
    _assert_matches(got, ref)
    want = {"fused": [("speculative_planar4_chunks", True)],
            "positions": [("speculative_positions", True)] + [
                ("decode_values_planar4_pair", True)] * 2,
            "serial": [],
            "index": [("decode_values_planar4_pair", True)] * 2,
            "index_wide": []}[route]
    assert called == want
    _assert_matches(j_entropy.parallel_chunks(buf, V, n_chunks, j_entropy.decode_values_planar4,
                                              positions=positions), ref)


def test_pair_decoder_equals_jax_and_two_singles():
    rng = np.random.default_rng(6)
    V = 20000
    buf = _stream(CASES["mixed"](rng, 3 * V))
    ref = _serial(buf, 3, V)
    got = entropy.decode_values_planar4_pair(buf, V, ref[0][3], ref[1][3])
    want = j_entropy.decode_values_planar4_pair(buf, V, ref[0][3], ref[1][3])
    _assert_matches(got, ref[1:])
    _assert_matches(want, ref[1:])
    with pytest.raises(EOFError):
        entropy.decode_values_planar4_pair(buf[:100], V, 0, 8)


def test_nibble_copy_all_offsets():
    lib = native.load()
    rng = np.random.default_rng(9)
    src = rng.integers(0, 256, 4096, dtype=np.uint8)
    src_n = np.empty(src.size * 2, np.uint8)  # src as a list of nibbles
    src_n[0::2] = src & 0xF
    src_n[1::2] = src >> 4
    for d0, s0, count in [(0, 0, 100), (1, 0, 99), (0, 1, 99), (1, 1, 98), (3, 8, 1),
                          (2, 5, 0), (7, 2, 513), (100, 771, 2048), (1, 2, 4095)]:
        dst = rng.integers(0, 256, 2100, dtype=np.uint8)
        want = np.empty(dst.size * 2, np.uint8)
        want[0::2] = dst & 0xF
        want[1::2] = dst >> 4
        want[d0 : d0 + count] = src_n[s0 : s0 + count]
        lib.nibble_copy(dst.ctypes.data, d0, src.ctypes.data, s0, count)
        got = np.empty(dst.size * 2, np.uint8)
        got[0::2] = dst & 0xF
        got[1::2] = dst >> 4
        np.testing.assert_array_equal(got, want, err_msg=f"d0={d0} s0={s0} count={count}")


@pytest.mark.parametrize("seed", range(12))
def test_fused_randomized_stress(seed):
    """The randomized content mixes and chunk geometries of
    tests/test_speculative.py, through both packages."""
    rng = np.random.default_rng(1000 + seed)
    n_chunks = int(rng.integers(2, 9))
    V = int(rng.integers(10000, 60000)) * 2
    n = n_chunks * V
    spread = int(rng.integers(1, 9))
    v = rng.integers(-spread, spread + 1, n).astype(np.int32)
    wide_frac = float(rng.choice([0.0, 0.001, 0.01, 0.2]))
    if wide_frac:
        p = rng.choice(n, max(1, int(n * wide_frac)), replace=False)
        v[p] = rng.integers(-50000, 50000, p.size)
    if rng.random() < 0.5:  # zero-run bursts
        for s in range(0, n, max(1, n // int(rng.integers(3, 9)))):
            v[s : s + int(rng.integers(8, 80))] = int(rng.integers(2**16, 2**25))
    buf = _stream(v)
    got, want = _both(buf, V, n_chunks, int(rng.integers(2, 5)))
    assert got is not None, "the fused decode did not engage"
    ref = _serial(buf, n_chunks, V)
    _assert_matches(got, ref)
    _assert_matches(want, ref)


@pytest.fixture(scope="module")
def noisy_stream():
    """A stream whose payload is large enough for several segments at the
    patched minimum: 48 frames of 64x64 noise-heavy content."""
    clip = synthetic_video(48, 64, 64, seed=31)
    clip ^= np.random.default_rng(31).integers(0, 64, clip.shape, dtype=np.uint8)
    ctx = TransformContext(CodecConfig(), "cpu")
    data = encode_video(clip, ctx=ctx)
    return data, ctx


def test_decode_video_without_positions_is_speculative(noisy_stream, monkeypatch):
    """decode_video with no positions goes through the fused decode and
    gives the indexed decode's pixels; decode_frame_range's prefix skip
    picks the speculative scan when the estimated work favours it (one
    worker) and the serial walk otherwise (many), both equal to the
    slice."""
    import zlib

    data, ctx = noisy_stream
    # Large enough for several segments, and for the serial walk to win
    # at one worker (g1 * cpg < 6.7 * payload bytes).
    assert len(zlib.decompress(data)) > 6 * 64 * 64 * 8 / 6.7
    called = []
    orig = {n: getattr(entropy, n) for n in ("speculative_planar4_chunks",
                                             "speculative_positions")}
    for name, fn in orig.items():
        monkeypatch.setattr(entropy, name, lambda *a, _fn=fn, _n=name, **k: (
            called.append(_n), _fn(*a, **k))[1])
    full = decode_video(data, 64, 64, 48, ctx=ctx)
    assert called == ["speculative_planar4_chunks"]
    payload = np.frombuffer(zlib.decompress(data), np.uint8)
    ends = [0]
    for _ in range(5):
        ends.append(entropy.scan_values(payload, 64 * 64 * 8, ends[-1]))
    np.testing.assert_array_equal(full, decode_video(data, 64, 64, 48, ctx=ctx, positions=ends))
    for workers, want in ((16, "speculative_positions"), (1, None)):
        called.clear()
        got = decode_frame_range(data, 64, 64, 33, 41, ctx=ctx, entropy_workers=workers)
        np.testing.assert_array_equal(got, full[33:41])
        assert (want in called) if want else "speculative_positions" not in called
