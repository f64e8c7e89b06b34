"""Host-side debug rendering (optional; never touches simulation state)."""
from .draw import Renderer

__all__ = ["Renderer"]
