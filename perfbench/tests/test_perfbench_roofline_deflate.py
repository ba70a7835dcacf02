"""The DEFLATE kernels' byte files at one 1080p 8x8x8 GOP of the bench
clip (2.5626 MB of Exp-Golomb bytes) against PERF.md's kernel table: the
buffers sized by the GOP's bytes exactly, the symbol- and span-sized ones
never above what the card moved there (1.9 MB of uint32 tokens, 475,000
symbols, a 0.64 MB span, 29 blocks)."""

import pytest

from perfbench import spec

GOP = {"frames": 8, "height": 1080, "width": 1920, "cube": 512, "cubes": 32400,
       "value_bytes": 4, "stream_bits": 8 * 2.5626e6, "exceptions": 0}
MB = 1e6
SYMBOLS, SPAN, BLOCKS = 475_000, 0.64 * MB, 29


@pytest.mark.parametrize("symbol,table_mb", [
    ("chains_kernel", 2.5626 + 15.38), ("match_kernel", 17.94 + 10.25),
    ("adler_kernel", 2.5626)])
def test_byte_sized_figures(symbol, table_mb):
    assert spec.kernel_bytes(symbol)(GOP) / MB == pytest.approx(table_mb, abs=0.01)


@pytest.mark.parametrize("symbol,moved", [
    ("parse_kernel", 5 * 2.5626 * MB + 4 * SYMBOLS),
    ("compact_kernel", 2 * 4 * SYMBOLS),
    ("plan_kernel", 4 * SYMBOLS + 4096 * BLOCKS),
    ("layout_kernel", 4100 * BLOCKS),
    ("emit_kernel", 4 * SYMBOLS + 4096 * BLOCKS + SPAN)])
def test_content_sized_figures_read_low(symbol, moved):
    assert 0 < spec.kernel_bytes(symbol)(GOP) <= moved
