"""GLFW-style input event surface.

Counterpart of marl_traffic_intersection_tpu/envs/events.py, plain Python.
The reference's pybind11 env exposes ``window_should_close / poll_events /
key_pressed(glfw_key)`` (cpp/bindings.cpp:80-82), and its manual harness
drives them in a real-time loop (test.py:110-145). The port's renderer is a
host-side debug path (render/draw.py + matplotlib), so the equivalent surface
is backed by matplotlib key events when a figure is attached, and by
programmatic injection (``inject_press`` etc.) when headless, which is also
what the tests drive.

GLFW keycodes follow glfw3.h: printable keys are their ASCII uppercase
(``ord('R') == 82``), arrows/escape are in the 256+ range.
"""
from __future__ import annotations

from typing import Optional, Set

# glfw3.h values used by the reference harness (test.py:59-67)
KEY_ESCAPE = 256
KEY_RIGHT = 262
KEY_LEFT = 263
KEY_DOWN = 264
KEY_UP = 265

_MPL_TO_GLFW = {
    "up": KEY_UP, "down": KEY_DOWN, "left": KEY_LEFT, "right": KEY_RIGHT,
    "escape": KEY_ESCAPE,
}


def _glfw_code(name: str) -> Optional[int]:
    """Map a matplotlib key name to a GLFW keycode."""
    if name is None:
        return None
    name = name.lower()
    if name in _MPL_TO_GLFW:
        return _MPL_TO_GLFW[name]
    if len(name) == 1:
        return ord(name.upper())
    return None


class EventSurface:
    """Polled keyboard/window state with the reference's query API."""

    def __init__(self):
        self._down: Set[int] = set()
        self._pending: Set[int] = set()      # injected between polls
        self._pending_up: Set[int] = set()
        self._close = False
        self._canvas = None

    # ------------------------------------------------- reference query API
    def poll_events(self) -> None:
        """Pump pending events (bindings.cpp:81; glfwPollEvents).

        With an attached matplotlib canvas this flushes its GUI event loop
        so key handlers fire; injected presses/releases are applied either
        way."""
        if self._canvas is not None:
            try:
                self._canvas.flush_events()
            except Exception:
                pass
        self._down |= self._pending
        self._down -= self._pending_up
        self._pending.clear()
        self._pending_up.clear()

    def key_pressed(self, glfw_key: int) -> bool:
        """True while the key is held (bindings.cpp:82; glfwGetKey)."""
        return int(glfw_key) in self._down

    def window_should_close(self) -> bool:
        """True once the window close was requested (bindings.cpp:80)."""
        return self._close

    # ---------------------------------------------------- host-side wiring
    def attach_matplotlib(self, fig) -> None:
        """Bind to a matplotlib figure's key/close events (play.py path)."""
        self._canvas = fig.canvas
        fig.canvas.mpl_connect(
            "key_press_event", lambda e: self.inject_press(_glfw_code(e.key)))
        fig.canvas.mpl_connect(
            "key_release_event",
            lambda e: self.inject_release(_glfw_code(e.key)))
        fig.canvas.mpl_connect("close_event", lambda e: self.request_close())

    def inject_press(self, glfw_key: Optional[int]) -> None:
        if glfw_key is not None:
            self._pending.add(int(glfw_key))
            self._pending_up.discard(int(glfw_key))

    def inject_release(self, glfw_key: Optional[int]) -> None:
        if glfw_key is not None:
            self._pending_up.add(int(glfw_key))
            self._pending.discard(int(glfw_key))

    def request_close(self) -> None:
        self._close = True
