"""Run the root ``tools/`` sweeps and the port's twins on narrowed grids,
shared by the ``test_torch_sweeps*`` files.

The JAX tools fix their grids in local literals.  ``run_jax_narrowed``
runs a tool function's own source with those literals replaced: each
replaced text must occur exactly once, so a tool whose code moved fails
here instead of running another grid.  Nothing in ``tools/`` changes.
"""

import contextlib
import importlib.util
import inspect
import io
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from gen2_rfid_tpu_torch.tools.sweep import run_twin

REPO = Path(__file__).resolve().parents[1]


def jax_tool(name: str):
    """``tools/<name>.py`` as a module of its own name-space (it does not
    clash with a ``sys.path`` import of the same file elsewhere)."""
    key = f"jax_tool_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, REPO / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def run_jax_narrowed(module, func: str, edits=(), argv=None):
    """Standard output lines of ``module.func()`` with each (old, new) text
    of ``edits`` replaced once in its source; ``argv`` replaces
    ``sys.argv[1:]`` while it runs."""
    src = textwrap.dedent(inspect.getsource(getattr(module, func)))
    for old, new in edits:
        assert src.count(old) == 1, f"{module.__name__}.{func}: {old!r}"
        src = src.replace(old, new)
    ns = dict(vars(module))
    exec(compile(src, f"<{module.__name__}.{func}, narrowed>", "exec"), ns)
    saved = sys.argv
    sys.argv = [func] + list(argv or [])
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            ns[func]()
    finally:
        sys.argv = saved
    return buf.getvalue().splitlines()


def run_port(twin, argv):
    """Standard output lines of a twin's ``main(argv)`` on the CPU."""
    return run_twin(twin, argv, "cpu")[0]


@pytest.fixture(autouse=True)
def keep_tf32_flags():
    """A twin's ``main`` turns both TF32 flags off, as an entry point does;
    the tests put them back for the rest of the worker's tests."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
