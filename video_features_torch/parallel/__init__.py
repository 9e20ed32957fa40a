"""Execution across videos, devices and processes: the batch-major packed
loop (``packing``), device meshes (``mesh``, ``pipeline``, ``ring``) and
several processes over one worklist (``distributed``, ``worklist``)."""
