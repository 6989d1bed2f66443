"""Hand-written CUDA kernels of the port, and how often each was launched.

Each wrapper adds one to its entry in ``launches`` when it launches its CUDA
kernel, and nowhere else: a CPU tensor takes the plain PyTorch version and
counts nothing.  A caller that wants to show that a run went through the
kernels calls ``reset_launches()`` before it and reads ``launches`` after.
"""

launches = {"gate_front": 0, "gate_stack": 0, "gate_scan": 0, "probe": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
