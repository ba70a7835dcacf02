#!/usr/bin/env python
"""Print the JAX CLI's constants that chip_smoke.py holds the port's CLI to
(JAX_CLI_CONSTANTS).

    JAX_PLATFORMS=cpu python tools/jax_cli_constants.py [W H T]

Writes chip_smoke.py's bench clip (1920x1080x64 by default) as a raw file
in a temporary directory, runs the JAX package's ``python -m dct3d_tpu
encode`` on it with default flags (an indexed D3MH container, parallel
DEFLATE-9), and prints the sha256 of the temporal member's inflated
payload, the index member's per-GOP bit ends, the file's
chip_smoke.container_digest (member frame counts and types, the inflated
payload, the index's bit ends) and its bits per pixel.  The sync offsets
and the compressed bytes depend on the zlib build, so they are not
pinned.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import sys
import tempfile
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from dct3d_tpu import cli  # noqa: E402
from dct3d_tpu.parallel import multihost  # noqa: E402


def main(argv: list[str]) -> None:
    w, h, t = (int(a) for a in argv) if argv else (chip_smoke.W, chip_smoke.H, chip_smoke.T)
    with tempfile.TemporaryDirectory() as d:
        src, out = os.path.join(d, "src.raw"), os.path.join(d, "out.d3v")
        chip_smoke.synthetic_clip(t, h, w).tofile(src)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["encode", src, out, str(w), str(h)])
        if rc:
            raise SystemExit(f"encode exited {rc}")
        with open(out, "rb") as f:
            data = f.read()
    (_, payload, _), (_, index, _) = multihost.split_members(data)
    print(json.dumps({"JAX_CLI_CONSTANTS": {
        "payload_sha256": hashlib.sha256(zlib.decompress(payload)).hexdigest(),
        "index_ends": multihost.parse_index(index),
        "digest": chip_smoke.container_digest(data),
        "bpp": len(data) * 8 / (w * h * t),
    }}))


if __name__ == "__main__":
    main(sys.argv[1:])
