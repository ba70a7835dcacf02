"""A tiny size of every cell, for runs on the CPU."""

TINY = {
    "config": {"width": 64, "height": 48},
    "traffic": {"frames_per_file": 16, "pool_frames": 24, "container_frames": 32,
                "max_len": 12, "sample_from": 6, "sample_requests": 3,
                "trace_first": 0, "trace_ops": 2},
}
