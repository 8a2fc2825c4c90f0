"""The command line: train / inference (``main``), evaluation and the live
stream."""
