"""Hand-written CUDA kernels of the port, and how often each was launched.

A wrapper's launch (``_build.launch``) adds one to its entry in
``launches`` when its CUDA kernel launches, and nothing else does: a CPU
tensor takes the plain PyTorch version and counts nothing.  A caller that wants to show that a run went through the
kernels calls ``reset_launches()`` before it and reads ``launches`` after.
``stack_bodies`` splits gate_stack's launches by the kernel body that ran:
the stream kernel at ReaderConfig's widths, the segment kernel at any other.
``front_bodies`` splits gate_front's launches by build: "y" (y alone, every
path that reads only y) and "full" (y, |y| and both windowed sums: compat
mode and the exact gate).

``keep_inputs(True)`` has gate_front, gate_stack, compat_gate and gate_pulses keep, in
``kept``, a copy of the first input each launches its kernel on for every
distinct shape and geometry (gate_front's geometry starts with its build;
compat_gate keeps amp and avg stacked), so that a caller can hold the
kernels against their plain versions at the shapes a run gave them.
"""

launches = {"gate_front": 0, "gate_stack": 0, "gate_scan": 0, "compat_gate": 0, "probe": 0,
            "gate_pulses": 0}
stack_bodies = {"stream": 0, "segment": 0}
front_bodies = {"full": 0, "y": 0}
kept = {}
_keeping = [False]


def reset_launches() -> None:
    for counts in (launches, stack_bodies, front_bodies):
        for name in counts:
            counts[name] = 0


def keep_inputs(on: bool) -> None:
    """Start (emptying ``kept``) or stop keeping the kernels' inputs."""
    if on:
        kept.clear()
    _keeping[0] = on


def keep(name: str, x, geometry: tuple) -> None:
    """Keep a copy of ``x`` under (name, shape, *geometry) once, while on;
    ``x`` a tensor, or a tuple of tensors of one shape kept stacked (the
    copy is made only for a key not kept yet)."""
    if _keeping[0]:
        shape = (len(x),) + tuple(x[0].shape) if isinstance(x, tuple) else tuple(x.shape)
        key = (name, shape) + tuple(geometry)
        if key not in kept:
            if isinstance(x, tuple):
                import torch

                kept[key] = torch.stack(x)
            else:
                kept[key] = x.clone()
