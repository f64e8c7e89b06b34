"""Native host engine: microsecond-latency single-instance C++ runtime."""
from .host import NativeEngine, native_available

__all__ = ["NativeEngine", "native_available"]
