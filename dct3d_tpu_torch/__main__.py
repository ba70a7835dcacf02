"""``python -m dct3d_tpu_torch``: the port's command-line interface (cli.py)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
