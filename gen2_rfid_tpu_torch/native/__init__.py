"""Native (C++) runtime components, loaded via ctypes."""

from .engine import NativeEngine, native_available  # noqa: F401
