"""Container framing shared by the port's profiles (parallel/multihost.py)."""
