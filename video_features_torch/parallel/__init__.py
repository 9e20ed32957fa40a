"""Execution across videos: the batch-major packed loop (``packing``)."""
