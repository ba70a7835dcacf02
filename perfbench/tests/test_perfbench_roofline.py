"""The kernels' essential bytes at one 1080p 8x8x8 GOP against the figures
of PERF.md's kernel table, which count each word a kernel writes: the byte
functions count K2's and K3's group words at the stream's size, so they
read at most 5 % lower, never higher."""

import pytest

from perfbench import spec

GOP = {"frames": 8, "height": 1080, "width": 1920, "cube": 512, "cubes": 32400,
       "value_bytes": 4, "stream_bits": 8 * 2.566e6, "exceptions": 0}
MB = 1e6


@pytest.mark.parametrize("symbol,value_bytes,table_mb", [
    ("frames_to_cubes_kernel", 4, 83.07),
    ("frames_to_cubes_kernel", 2, 49.90),
    ("cubes_to_frames_kernel", 4, 82.94),
    ("cubes_to_frames_kernel", 2, 49.77),
    ("group_bits_kernel", 4, 66.61),
    ("transpose_u8_kernel", 4, 16.59),
])
def test_exact_figures(symbol, value_bytes, table_mb):
    f = {**GOP, "value_bytes": value_bytes}
    assert spec.kernel_bytes(symbol)(f) / MB == pytest.approx(table_mb, abs=0.006)


@pytest.mark.parametrize("symbol,table_mb", [
    ("group_pack_values_kernel", 69.42), ("splice_kernel", 5.89)])
def test_stream_sized_figures(symbol, table_mb):
    got = spec.kernel_bytes(symbol)(GOP) / MB
    assert 0.95 * table_mb <= got <= table_mb


def test_exceptions_count_instead_of_table_slots():
    # PERF.md's 69.72 MB counts every one of the 16 slots of each group.
    slots = {**GOP, "exceptions": 16 * 64800}
    assert spec.kernel_bytes("compact_groups_kernel")(slots) / MB == pytest.approx(69.72, abs=0.006)
    assert spec.kernel_bytes("compact_groups_kernel")(GOP) / MB < 69.72


def test_every_port_kernel_has_a_byte_file():
    import glob
    import re
    names = set()
    for path in glob.glob(f"{spec.ROOT}/dct3d_tpu_torch/csrc/*.cu"):
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                                 open(path).read()))
    assert names and all(spec.kernel_bytes(n) is not None for n in names)
