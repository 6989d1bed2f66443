"""PyTorch + CUDA port of the Gen2 UHF RFID batch decoder.

Runs the decode of ``gen2_rfid_tpu`` (the JAX package, which stays the
reference) on an NVIDIA GPU: ``runtime.inventory.decode_capture`` and
``decode_capture_planar``, with the gate front end, the gate flag stack and
the exact gate as hand-written CUDA kernels (``kernels/``, ``csrc/``), and
the offline CLI over it (``python -m gen2_rfid_tpu_torch.apps.reader``).
The package imports neither JAX nor ``gen2_rfid_tpu``.
"""
