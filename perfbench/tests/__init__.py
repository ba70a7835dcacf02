"""CPU tests of the benchmark itself; the card-only ones carry the ``cuda`` marker."""
