"""dct3d_tpu_torch — the PyTorch/CUDA port of the dct3d_tpu codec.

A second package beside the JAX one, for one NVIDIA H100 (Hopper, sm_90a).
It encodes and decodes reference-profile streams (signed Exp-Golomb inside
zlib) and turbo-profile containers (codec/turbo.py: nibble plane, dense DC
and exceptions, compressed per GOP) byte-compatible with ``dct3d_tpu``:
the transform is torch.matmul in full float32 (or in bfloat16, the fast
profile of ``CodecConfig(compute_dtype="bfloat16")``), and the device
kernels of both paths are hand-written CUDA (csrc/, built with nvcc on
first use, see kernels.py; K1 and K4 have a bfloat16 form each):

  K1 frames -> cubes         ops/relayout.py    csrc/relayout.cu   both
  K2 group bit pack          ops/group_pack.py  csrc/group_pack.cu reference
  K3 group splice            ops/splice.py      csrc/splice.cu     reference
  K4 cubes -> frames         ops/relayout.py    csrc/relayout.cu   both
  K5 group bit pack, codes   ops/group_pack.py  csrc/group_pack.cu reference
  K6 exception compaction    ops/exc_pack.py    csrc/exc_pack.cu   turbo
  K7 plane -> wire           ops/relayout.py    csrc/wire.cu       turbo
  K8 wire -> plane           ops/relayout.py    csrc/wire.cu       turbo

K1 and K4 cover 8x8x8 cubes; the alternate blocks (4x4x4, 8x8x4) take
framing's transposes, and batches that are not whole 256-value groups take
K5 (``ops/bitpack.pack_bits``).  ``io/pad.py`` edge-replicates frames up to
block multiples and crops them back.

Default encodes wrap the stream in an indexed D3MH container
(parallel/multihost.py); colour clips travel as three channel members
(codec/rgb_codec.py, and turbo RGB in codec/turbo.py); the checkpointing
encoder writes a resumable member container (codec/checkpoint.py).
``decode_auto`` (codec/auto.py) reads every form the port writes, and
``python -m dct3d_tpu_torch`` (cli.py) is the command line of the JAX
package's ``python -m dct3d_tpu``.

Every public entry point takes an explicit ``device`` (or a
``TransformContext`` that holds one): on "cuda" the kernels run, on "cpu"
their plain PyTorch versions.  The package imports torch and never jax.
"""

from .codec.auto import decode_auto, decode_auto_range
from .codec.checkpoint import CheckpointingEncoder, resume_info
from .codec.decoder import (
    StreamingDecoder, decode_frame_range, decode_stream, decode_video,
)
from .codec.encoder import StreamingEncoder, encode_stream, encode_video
from .codec.rgb_codec import decode_rgb_range, decode_rgb_video, encode_rgb_video
from .codec.transform import TransformContext
from .codec.turbo import (
    TurboEncoder, decode_turbo_container, decode_turbo_range,
    decode_turbo_rgb_range, decode_turbo_rgb_video, encode_turbo_rgb_video,
    encode_turbo_video,
)
from .config import DEFAULT_CONFIG, CodecConfig
from .io.pad import crop_frames, pad_frames, padded_geometry
from .metrics import bits_per_pixel, psnr
from .profiling import StageTimer

__all__ = [
    "CheckpointingEncoder",
    "CodecConfig",
    "DEFAULT_CONFIG",
    "StageTimer",
    "StreamingDecoder",
    "StreamingEncoder",
    "TransformContext",
    "TurboEncoder",
    "bits_per_pixel",
    "crop_frames",
    "decode_auto",
    "decode_auto_range",
    "decode_frame_range",
    "decode_rgb_range",
    "decode_rgb_video",
    "decode_stream",
    "decode_turbo_container",
    "decode_turbo_range",
    "decode_turbo_rgb_range",
    "decode_turbo_rgb_video",
    "decode_video",
    "encode_rgb_video",
    "encode_stream",
    "encode_turbo_rgb_video",
    "encode_turbo_video",
    "encode_video",
    "pad_frames",
    "padded_geometry",
    "psnr",
    "resume_info",
]
