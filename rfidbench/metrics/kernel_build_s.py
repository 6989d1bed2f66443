"""Kernel build and load: the seconds this process spent building the
port's CUDA libraries with nvcc (``kernels/_build.py::build_seconds``), 0
where every library was built before; so it says whether ``setup_s`` held
a build."""


def read(trace):
    if not trace.device:
        return None
    try:
        from gen2_rfid_tpu_torch.kernels import _build
    except ImportError:
        return None
    built = getattr(_build, "build_seconds", None)
    return None if built is None else float(sum(built.values()))
