"""PyTorch + CUDA port of the Gen2 UHF RFID batch decoder.

Runs the native FM0 decode of ``gen2_rfid_tpu`` (the JAX package, which
stays the reference) on an NVIDIA GPU: ``runtime.inventory.decode_capture``
and ``decode_capture_planar``, with the gate front end and the gate flag
stack as hand-written CUDA kernels (``kernels/``, ``csrc/``).  The package
imports neither JAX nor ``gen2_rfid_tpu``.
"""
