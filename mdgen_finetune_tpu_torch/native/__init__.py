"""The C++ batch loader (``native/loader.cpp``) and its ctypes binding."""
from .loader import NativeLoader, build_native_library

__all__ = ["NativeLoader", "build_native_library"]
