"""Native host-side runtime components (C++, loaded via ctypes)."""
from .loader import NativeNpyStream, native_available
