"""The port's CLI (``python -m dct3d_tpu_torch``) against the JAX
package's (``python -m dct3d_tpu``), both called in-process on the same
files; the port runs with ``--device cpu`` (the kernels' plain versions).

Every encode case writes a file (and sidecar) byte-equal to the JAX CLI's
on this machine's zlib; each CLI decodes the other's file exactly as it
decodes its own, and the two CLIs' pixels stay within 1 LSB on < 1% of
pixels (their f32 matmuls sum in different orders).  Mirrors
tests/test_cli_io.py, test_seekable_default.py, test_footage.py and the
CLI cases of test_index.py and test_range.py.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from conftest import synthetic_video
from dct3d_tpu import cli as jcli
from dct3d_tpu.io import rawvideo
from dct3d_tpu_torch import cli
from dct3d_tpu_torch.parallel import multihost

torch.set_num_threads(2)

T, H, W = 24, 48, 64
CPU = ["--device", "cpu"]

#: case -> (encode flags, geometry given to decode, decode flags, frames a
#: raw stream needs); a geometry of None is read from the .meta sidecar
CASES = {
    "default": ([], (W, H), [], None),
    "no_index": (["--no-index"], (W, H), [], T),
    "parity": (["--parity"], (W, H), [], T),
    "parity_index": (["--parity", "--index"], (W, H), [], None),
    "turbo_zlib": (["--turbo", "--turbo-codec", "zlib"], (W, H), [], None),
    "block4_pad": (["--block", "4", "--pad"], (44, 28), ["--block", "4", "--crop", "42x26"],
                   None),
    "stdin_index": (["--index"], (W, H), [], None),
    "transport_delta": (["--transport-delta"], (W, H), [], None),
    "rgb": (["--rgb"], (W, H), [], None),
    "rgb_turbo": (["--rgb", "--turbo", "--turbo-codec", "zlib"], (W, H), [], None),
    "checkpoint": (["--checkpoint-every", "2", "--index"], None, [], None),
}
#: cases whose source is interleaved RGB (3 bytes a pixel)
RGB = ("rgb", "rgb_turbo")


class _Pipe:
    """A stdin/stdout stand-in whose ``buffer`` is a BytesIO."""

    def __init__(self, data=b""):
        self.buffer = io.BytesIO(data)

    def flush(self):
        pass


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    clip = synthetic_video(T, H, W, seed=7)
    src = str(d / "src.raw")
    rawvideo.write_video(src, clip)
    odd = synthetic_video(T, 26, 42, seed=8)  # pads to 44x28 at 4x4 blocks
    odd_src = str(d / "odd.raw")
    rawvideo.write_video(odd_src, odd)
    rgb = np.stack([synthetic_video(T, H, W, seed=s) for s in (4, 5, 6)], axis=-1)
    rawvideo.write_video(str(d / "src.rgb"), rgb)
    return d, src, odd_src


def _encode(main, d, src, case, tag, extra=()):
    flags, _, _, _ = CASES[case]
    out = str(d / f"{case}.{tag}")
    if case == "block4_pad":
        argv = ["encode", src, out, "42", "26", *flags]
    elif case == "stdin_index":
        argv = ["encode", "-", out, str(W), str(H), *flags]
    else:
        argv = ["encode", src, out, str(W), str(H), *flags]
    with pytest.MonkeyPatch.context() as mp:
        if case == "stdin_index":
            mp.setattr("sys.stdin", _Pipe(open(src, "rb").read()))
        assert main([*argv, *extra]) == 0
    return out


@pytest.fixture(scope="module")
def encoded(work):
    d, src, odd_src = work
    out = {}
    for case in CASES:
        s = {"block4_pad": odd_src, "rgb": str(d / "src.rgb"),
             "rgb_turbo": str(d / "src.rgb")}.get(case, src)
        out[case] = (_encode(jcli.main, d, s, case, "jax"),
                     _encode(cli.main, d, s, case, "port", CPU))
    return out


def _geometry(case):
    """The command line's geometry of a decode: none after a checkpointing
    encode (its .meta sidecar gives it)."""
    geo = CASES[case][1]
    return [] if geo is None else [str(geo[0]), str(geo[1])]


def _decode(main, path, case, out, extra=()):
    _, _, flags, frames = CASES[case]
    argv = ["decode", path, out, *_geometry(case)]
    if frames is not None:
        argv.append(str(frames))
    assert main([*argv, *flags, *extra]) == 0
    return np.fromfile(out, np.uint8)


@pytest.fixture(scope="module")
def decoded(work, encoded):
    """(case, decoding CLI, encoding CLI) -> flat pixels."""
    d = work[0]
    out = {}
    for case, (jfile, pfile) in encoded.items():
        for enc, path in (("jax", jfile), ("port", pfile)):
            out[case, "port", enc] = _decode(cli.main, path, case,
                                             str(d / f"{case}.{enc}.p.raw"), CPU)
            out[case, "jax", enc] = _decode(jcli.main, path, case,
                                            str(d / f"{case}.{enc}.j.raw"))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_files_byte_equal_jax(encoded, case):
    jfile, pfile = encoded[case]
    assert open(jfile, "rb").read() == open(pfile, "rb").read()
    assert os.path.exists(pfile + ".idx") == (case == "parity_index")
    if case == "parity_index":
        assert open(jfile + ".idx", "rb").read() == open(pfile + ".idx", "rb").read()
    assert os.path.exists(pfile + ".meta") == (case == "checkpoint")
    if case == "checkpoint":
        assert open(jfile + ".meta", "rb").read() == open(pfile + ".meta", "rb").read()
    head = open(pfile, "rb").read(4)
    assert (head == b"D3MH") == (case not in ("no_index", "parity", "parity_index"))


@pytest.mark.parametrize("case", list(CASES))
def test_cross_decode(decoded, case):
    """Each CLI decodes the other's file exactly as its own; the two CLIs'
    pixels agree within 1 LSB on < 1%; every frame comes back."""
    port, jax = decoded[case, "port", "port"], decoded[case, "jax", "jax"]
    np.testing.assert_array_equal(decoded[case, "port", "jax"], port)
    np.testing.assert_array_equal(decoded[case, "jax", "port"], jax)
    _, _, flags, _ = CASES[case]
    w, h = (42, 26) if "--crop" in flags else (W, H)
    assert port.size == T * w * h * (3 if case in RGB else 1)
    diff = np.abs(port.astype(np.int16) - jax)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


@pytest.mark.parametrize("case", list(CASES))
def test_range_equals_slice(work, encoded, decoded, case):
    d = work[0]
    _, _, flags, _ = CASES[case]
    out = str(d / f"{case}.range.raw")
    assert cli.main(["decode", encoded[case][1], out, *_geometry(case), "--range", "5:19",
                     *flags, *CPU]) == 0
    full = decoded[case, "port", "port"]
    px = ((42 * 26) if "--crop" in flags else (W * H)) * (3 if case in RGB else 1)
    np.testing.assert_array_equal(np.fromfile(out, np.uint8), full[5 * px : 19 * px])


@pytest.mark.parametrize("case", list(CASES))
def test_info_equal_jax(encoded, capsys, case):
    jfile, pfile = encoded[case]
    capsys.readouterr()
    assert jcli.main(["info", jfile]) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main(["info", pfile]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == want
    if case == "default":
        assert got["kind"] == "temporal"
        assert [m["type"] for m in got["members"]] == ["temporal", "index"]
        assert got["members"][1]["gops"] == 3 and got["members"][1]["parallel_inflate"]


def test_container_payload_is_the_stream(encoded):
    """The default container's member is the --no-index stream, and its
    index ends and syncs are the encoder's."""
    members = multihost.split_members(open(encoded["default"][1], "rb").read())
    assert [(m[0], m[2]) for m in members] == [(T, 0), (0, 4)]
    assert members[0][1] == open(encoded["no_index"][1], "rb").read()
    ipay = members[1][1]
    assert len(multihost.parse_index(ipay)) == len(multihost.parse_index_syncs(ipay)) == 3


def test_decode_without_count_needs_an_index(work, encoded, tmp_path):
    assert cli.main(["decode", encoded["no_index"][1], str(tmp_path / "x.raw"),
                     str(W), str(H), *CPU]) == 2
    assert cli.main(["decode", "no-such-file", str(tmp_path / "x.raw"), "8", "8", *CPU]) == 2


def test_torn_sidecar_needs_a_count(work, encoded, tmp_path):
    """A garbage .idx sidecar cannot supply a frame count; with one, the
    counted decode still works."""
    _, src, _ = work
    p = str(tmp_path / "p.bin")
    assert cli.main(["encode", src, p, str(W), str(H), "--parity", "--index", *CPU]) == 0
    with open(p + ".idx", "wb") as f:
        f.write(b"garbage sidecar")
    assert cli.main(["decode", p, str(tmp_path / "a.raw"), str(W), str(H), *CPU]) == 2
    assert cli.main(["decode", p, str(tmp_path / "b.raw"), str(W), str(H), str(T), *CPU]) == 0
    assert os.path.getsize(tmp_path / "b.raw") == T * W * H


def test_stale_sidecar_is_scanned(work, encoded, decoded, tmp_path):
    """R1: the sidecar of another, noisier encode of the same geometry and
    frame count ends past this stream's payload.  The JAX CLI trusts it
    (ROADMAP Queue 3, R1); the port scans and decodes the right pixels."""
    _, src, _ = work
    noisy = str(tmp_path / "noisy.raw")
    rawvideo.write_video(noisy, np.random.default_rng(2).integers(0, 256, (T, H, W),
                                                                  dtype=np.uint8))
    other = str(tmp_path / "other.bin")
    assert cli.main(["encode", noisy, other, str(W), str(H), "--parity", "--index", *CPU]) == 0
    p = str(tmp_path / "p.bin")
    assert cli.main(["encode", src, p, str(W), str(H), "--parity", *CPU]) == 0
    os.replace(other + ".idx", p + ".idx")
    out = str(tmp_path / "out.raw")
    assert cli.main(["decode", p, out, str(W), str(H), *CPU]) == 0
    np.testing.assert_array_equal(np.fromfile(out, np.uint8), decoded["parity", "port", "port"])
    assert cli.main(["decode", p, out, str(W), str(H), "--range", "9:17", *CPU]) == 0
    np.testing.assert_array_equal(np.fromfile(out, np.uint8),
                                  decoded["parity", "port", "port"][9 * W * H : 17 * W * H])


def test_stdout_encode_is_raw_with_a_note(work, capsys, monkeypatch):
    """R3: stdout drops the default index, equal to the JAX CLI's bytes,
    and the port says so on stderr; --index to stdout exits 2."""
    _, src, _ = work
    outs = []
    for main, extra in ((jcli.main, []), (cli.main, CPU)):
        pipe = _Pipe()
        monkeypatch.setattr("sys.stdout", pipe)
        assert main(["encode", src, "-", str(W), str(H), *extra]) == 0
        outs.append(pipe.buffer.getvalue())
        monkeypatch.undo()
    assert outs[0] == outs[1] and outs[1][:4] != b"D3MH"
    assert "index is dropped" in capsys.readouterr().err
    assert cli.main(["encode", src, "-", str(W), str(H), "--index", *CPU]) == 2


def test_pipe_roundtrip_equals_jax(work, monkeypatch):
    """stdin -> stdout for encode (turbo, as the JAX test) and decode."""
    _, src, _ = work
    raw = open(src, "rb").read()
    results = []
    for main, extra in ((jcli.main, []), (cli.main, CPU)):
        monkeypatch.setattr("sys.stdin", _Pipe(raw))
        out = _Pipe()
        monkeypatch.setattr("sys.stdout", out)
        assert main(["encode", "-", "-", str(W), str(H), "--turbo", *extra]) == 0
        enc = out.buffer.getvalue()
        monkeypatch.setattr("sys.stdin", _Pipe(enc))
        out = _Pipe()
        monkeypatch.setattr("sys.stdout", out)
        assert main(["decode", "-", "-", str(W), str(H), *extra]) == 0
        results.append((enc, np.frombuffer(out.buffer.getvalue(), np.uint8)))
        monkeypatch.undo()
    assert results[0][0] == results[1][0]
    diff = np.abs(results[1][1].astype(np.int16) - results[0][1])
    assert results[1][1].size == T * W * H and diff.max() <= 1


class _OnDemand:
    """A pipe that fails on any unbounded read (the constant-RSS contract
    of ``encode -``), returning short reads."""

    def __init__(self, nbytes: int, chunk: int = 1 << 12):
        self.left, self.pos, self.chunk = nbytes, 0, chunk

    def read(self, n=None):
        assert n is not None and n > 0, "encode - must stream bounded reads"
        n = min(n, self.left, self.chunk)
        out = (np.arange(self.pos, self.pos + n) % 251).astype(np.uint8)
        self.pos += n
        self.left -= n
        return out.tobytes()


@pytest.mark.parametrize("flags", [["--pad"], []], ids=["pad", "trim"])
def test_stdin_streams_bounded_equal_jax(tmp_path, monkeypatch, flags):
    """A pipe of 17.5 frames at 30x21 (--pad: 32x24) or 32x32 encodes with
    bounded reads to the JAX CLI's bytes and decodes with no count."""
    w, h = (30, 21) if flags else (32, 32)
    total = 17 * w * h + w * h // 2
    outs = []
    for main, extra, name in ((jcli.main, [], "j"), (cli.main, CPU, "p")):
        monkeypatch.setattr("sys.stdin", type("Std", (), {"buffer": _OnDemand(total)}))
        out = str(tmp_path / f"{name}.bin")
        assert main(["encode", "-", out, str(w), str(h), *flags, *extra]) == 0
        monkeypatch.undo()
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]
    pw, ph = (32, 24) if flags else (w, h)
    dec = str(tmp_path / "d.raw")
    assert cli.main(["decode", str(tmp_path / "p.bin"), dec, str(pw), str(ph), *CPU]) == 0
    assert os.path.getsize(dec) == 16 * pw * ph


def test_png_and_y4m_input_and_y4m_output(tmp_path):
    """PNG directory and .y4m input with no geometry on the command line,
    .y4m output: files equal the JAX CLI's."""
    from dct3d_tpu.io import render
    from test_footage import _write_y4m

    clip = synthetic_video(16, 32, 48, seed=40)
    seq = tmp_path / "seq"
    seq.mkdir()
    for i in range(16):
        render._write_png(str(seq / f"frame_{i:04d}.png"), clip[i])
    y4m = str(tmp_path / "v.y4m")
    _write_y4m(y4m, clip)
    for name, inp in (("png", str(seq)), ("y4m", y4m)):
        files = []
        for main, extra, tag in ((jcli.main, [], "j"), (cli.main, CPU, "p")):
            enc = str(tmp_path / f"{name}.{tag}.bin")
            assert main(["encode", inp, enc, *extra]) == 0
            out = str(tmp_path / f"{name}.{tag}.y4m")
            assert main(["decode", enc, out, "48", "32", *extra]) == 0
            files.append((open(enc, "rb").read(), open(out, "rb").read()))
        assert files[0][0] == files[1][0]
        head = files[1][1][:60]
        assert head.startswith(b"YUV4MPEG2") and b"W48 H32" in head
        assert len(files[0][1]) == len(files[1][1])


@pytest.mark.parametrize("argv,item", [
    (["--rgb"], 11), (["--checkpoint-every", "2"], 11), (["--mesh", "1x1"], 12),
    (["--transport-delta"], 7), (["--dtype", "bfloat16"], 8), (["--dtype", "bf16"], 8),
])
def test_unported_flags_exit_2(work, tmp_path, capsys, argv, item):
    """The flags of ROADMAP Queue 1 items 7, 8, 11 and 12, all ported
    now, encode the JAX CLI's file and decode it with the same flags,
    naming no item.  --dtype bfloat16 (item 8) also decodes to the JAX
    CLI's pixels byte for byte; with --parity both CLIs exit 2 with the
    same message; its sweep rows carry the JAX CLI's "dtype" tag, bpp and
    PSNR (tests/test_cli_io.py:354-381)."""
    _, src, _ = work
    files = []
    for main, extra, tag in ((jcli.main, [], "j"), (cli.main, CPU, "p")):
        out = str(tmp_path / f"o.{tag}")
        assert main(["encode", src, out, str(W), str(H), *argv, *extra]) == 0
        files.append(open(out, "rb").read())
    assert files[0] == files[1]
    dec = str(tmp_path / "d.raw")
    assert cli.main(["decode", out, dec, str(W), str(H), *argv, *CPU]) == 0
    assert os.path.getsize(dec) == os.path.getsize(src) - os.path.getsize(src) % (
        8 * W * H * (3 if argv == ["--rgb"] else 1))
    assert "item" not in capsys.readouterr().err
    if argv[0] != "--dtype":
        return
    jdec = str(tmp_path / "j.raw")
    assert jcli.main(["decode", out, jdec, str(W), str(H), *argv]) == 0
    assert open(dec, "rb").read() == open(jdec, "rb").read()
    errs, rows = [], []
    for main, extra in ((jcli.main, []), (cli.main, CPU)):
        capsys.readouterr()
        assert main(["encode", src, str(tmp_path / "x"), str(W), str(H), *argv,
                     "--parity", *extra]) == 2
        errs.append(capsys.readouterr().err)
        assert main(["sweep", "synthetic", "16", "16", "8", "--quants", "5", "--blocks", "8",
                     *argv, *extra]) == 0
        rows.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert "--parity" in errs[0] and errs[0] == errs[1]
    for k in ("dtype", "bpp", "psnr_db"):
        assert rows[0][k] == rows[1][k], k
    assert rows[1]["dtype"] == "bfloat16"


@pytest.mark.parametrize("turbo", [False, True], ids=["reference", "turbo"])
def test_checkpoint_rerun_resumes_equal_jax(work, encoded, tmp_path, capsys, turbo):
    """`--checkpoint-every 2` run twice by the port resumes and leaves the
    file as it was; a file the JAX CLI began on the first 16 frames of the
    source resumes in the port to the JAX CLI's uninterrupted file."""
    _, src, _ = work
    flags = ["--checkpoint-every", "2", *(["--turbo", "--turbo-codec", "zlib"] if turbo else [])]
    whole = str(tmp_path / "whole.j")
    assert jcli.main(["encode", src, whole, str(W), str(H), *flags]) == 0
    out = str(tmp_path / "o.p")
    for _ in range(2):
        assert cli.main(["encode", src, out, str(W), str(H), *flags, *CPU]) == 0
    assert "resuming at frame 24" in capsys.readouterr().out
    assert open(out, "rb").read() == open(whole, "rb").read()
    half = str(tmp_path / "half.raw")
    rawvideo.write_video(half, rawvideo.read_video(src, W, H, 16))
    began = str(tmp_path / "began")
    assert jcli.main(["encode", half, began, str(W), str(H), *flags]) == 0
    assert cli.main(["encode", src, began, str(W), str(H), *flags, *CPU]) == 0
    assert "resuming at frame 16" in capsys.readouterr().out
    assert open(began, "rb").read() == open(whole, "rb").read()
    assert open(began + ".meta", "rb").read() == open(whole + ".meta", "rb").read()


def test_unported_containers_exit_2(tmp_path, capsys):
    """RGB and turbo-RGB containers (written by the JAX CLI with its zstd
    default where zstandard imports) and a checkpointed container with
    its .meta sidecar decode in the port, with and without --range, to the
    JAX CLI's pixels within 1 LSB; a container of unknown member types
    still exits 2."""
    from dct3d_tpu.io import synthetic

    src = str(tmp_path / "c.rgb")
    synthetic.capture(src, 8, 16, 16, rgb=True)
    plain = str(tmp_path / "p.raw")
    synthetic.capture(plain, 8, 16, 16)
    for name, inp, flags in (("rgb", src, ["--rgb"]), ("trgb", src, ["--rgb", "--turbo"]),
                             ("ck", plain, ["--checkpoint-every", "1"])):
        enc = str(tmp_path / f"{name}.bin")
        assert jcli.main(["encode", inp, enc, "16", "16", *flags]) == 0
        geo = [] if name == "ck" else ["16", "16"]
        for extra in ([], ["--range", "0:8"]):
            outs = []
            for main, cpu, tag in ((jcli.main, [], "j"), (cli.main, CPU, "p")):
                out = str(tmp_path / f"{name}.{tag}.raw")
                assert main(["decode", enc, out, *geo, *extra, *cpu]) == 0
                outs.append(np.fromfile(out, np.uint8))
            d = np.abs(outs[1].astype(np.int16) - outs[0])
            assert outs[1].size == 8 * 16 * 16 * (1 if name == "ck" else 3) and d.max() <= 1
    assert "item 11" not in capsys.readouterr().err
    bad = str(tmp_path / "bad.bin")
    with open(bad, "wb") as f:
        f.write(multihost._member(b"x", 8, 9))
    assert cli.main(["decode", bad, str(tmp_path / "o"), "16", "16", *CPU]) == 2
    assert "unrecognized" in capsys.readouterr().err


@pytest.mark.parametrize("cmd", ["encode", "decode", "sweep"])
def test_no_card_exits_2(work, tmp_path, monkeypatch, capsys, cmd):
    """Without a card the default device exits 2 with a message and never
    runs on the CPU; `devices` still exits 0."""
    _, src, _ = work
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"encode": ["encode", src, str(tmp_path / "o"), str(W), str(H)],
            "decode": ["decode", src, str(tmp_path / "o"), str(W), str(H), str(T)],
            "sweep": ["sweep", "synthetic", "16", "16", "8"]}[cmd]
    assert cli.main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "o")
    assert cli.main(["devices"]) == 0
    assert "no CUDA device" in capsys.readouterr().out


def test_stats_profile_and_ignored_flags(work, encoded, tmp_path, capsys):
    """--stats prints the stages on stderr, --profile-dir writes a trace,
    and --pack-bits / --gops-per-batch leave the bytes alone."""
    _, src, _ = work
    out = str(tmp_path / "o.bin")
    assert cli.main(["encode", src, out, str(W), str(H), "--stats", "--pack-bits", "6",
                     "--gops-per-batch", "1", "--profile-dir", str(tmp_path / "prof"),
                     *CPU]) == 0
    assert open(out, "rb").read() == open(encoded["default"][1], "rb").read()
    stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert stats["dispatch"]["calls"] == stats["sink_push"]["calls"] == 3
    assert stats["deflate"]["calls"] == 4  # a block a GOP, then the final byte
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    # The stage ranges of the calling thread and of the drainer and
    # DEFLATE workers are in the trace.
    assert {"dispatch", "sink_push", "deflate"} <= {e.get("name") for e in trace["traceEvents"]}
    assert cli.main(["decode", out, str(tmp_path / "d.raw"), str(W), str(H),
                     "--profile-dir", str(tmp_path / "prof2"), *CPU]) == 0
    assert os.path.exists(tmp_path / "prof2" / "trace.json")


def test_tools_equal_jax(tmp_path, capsys):
    """capture, split, mix, render, psnr and sweep: the same files and
    lines as the JAX CLI's (sweep: the same rows apart from the fps)."""
    outs = {}
    for main, extra, tag in ((jcli.main, [], "j"), (cli.main, CPU, "p")):
        d = tmp_path / tag
        d.mkdir()
        g = str(d / "g.raw")
        assert main(["capture", g, "40", "30", "16", "--kind", "blocks", "--seed", "3"]) == 0
        c = str(d / "c.rgb")
        assert main(["capture", c, "16", "16", "8", "--rgb"]) == 0
        assert main(["split", c]) == 0
        assert main(["mix", c, str(d / "m.rgb")]) == 0
        capsys.readouterr()
        assert main(["render", g, "40", "32", "--png-prefix", str(d / "f"),
                     "--frames", "0,5"]) == 0
        assert main(["psnr", g, str(d / "m.rgb"), "16", "16"]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert main(["sweep", "synthetic", "32", "32", "16", "--quants", "2,10",
                     "--blocks", "8", "--turbo", *extra]) == 0
        rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()
                if x.startswith("{")]
        files = {n: (d / n).read_bytes() for n in ("g.raw", "c.rgb", "c.rgb.red",
                                                   "c.rgb.green", "c.rgb.blue", "m.rgb",
                                                   "f_f00000.png", "f_f00005.png")}
        outs[tag] = (files, lines[0], lines[-1], rows)
    (jf, js, jp, jr), (pf, ps, pp, pr) = outs["j"], outs["p"]
    assert jf == pf and js == ps and jp == pp
    assert pf["m.rgb"] == pf["c.rgb"]
    drop = ("encode_fps", "decode_fps")
    assert [{k: v for k, v in r.items() if k not in drop} for r in pr] == \
        [{k: v for k, v in r.items() if k not in drop} for r in jr]
    assert len(pr) == 2 and pr[1]["bpp"] < pr[0]["bpp"]
