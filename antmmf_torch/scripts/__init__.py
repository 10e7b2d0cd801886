"""Command-line tools of the port: ``pink_eval`` and ``quantize_checkpoint``."""
