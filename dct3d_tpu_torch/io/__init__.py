"""Host-side video I/O helpers of the port (copies of ``dct3d_tpu.io`` modules)."""
