"""Host-side debug renderer (PIL), replicating the reference scene layout.

Counterpart of marl_traffic_intersection_tpu/render/draw.py, drawing the same
frames pixel for pixel. The reference renderer is a Windows-only
OpenGL/GLFW side-car (reference: cpp/Renderer.cpp; road surface :520-550,
lane markings :405-518, route polyline :377-403, cars :553-609, hit-only
lidar rays :612-645). Here rendering is a pure host-side debug path: one env
of an ``EnvState`` is moved to the host explicitly (``compat.host_state``)
and drawn as an RGB frame. It reads state only; the simulation stays on the
device. PIL and matplotlib are imported only where a frame is drawn or shown.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from ..compat import host_state

from ..core.constants import (
    CAR_LENGTH,
    CAR_WIDTH,
    CORNER_RADIUS,
    HEIGHT,
    LANE_WIDTH_PX,
    LIDAR_MAX_DIST,
    LIDAR_RAYS,
    WIDTH,
)
from ..core.lidar import ray_rel_angles

# Palette mirroring RenderColors.h roles
_GRASS = (34, 139, 34)
_ROAD = (60, 60, 60)
_YELLOW = (240, 200, 0)
_WHITE = (230, 230, 230)
_CAR_COLORS = [(66, 135, 245), (235, 64, 52), (52, 235, 86), (245, 188, 66),
               (188, 66, 245), (66, 235, 227)]
_NPC_COLOR = (160, 160, 160)
_LIDAR_HIT = (255, 80, 80)
_ROUTE = (0, 255, 255)       # RouteCyan (RenderColors.h:19)
_TARGET = (255, 0, 0)        # TargetRed (RenderColors.h:20)
_BOUNDARY = (0, 0, 0)        # RoadBoundary (RenderColors.h:40)


class Renderer:
    def __init__(self, core_env):
        from PIL import Image, ImageDraw  # noqa: F401 — import check

        self.env = core_env
        self.num_lanes = core_env.config.num_lanes
        self._bg = self._draw_background()
        self._rel_angles = ray_rel_angles()

    # ------------------------------------------------------------- background
    def _draw_background(self):
        from PIL import Image, ImageDraw

        img = Image.new("RGB", (WIDTH, HEIGHT), _GRASS)
        d = ImageDraw.Draw(img)
        cx, cy = WIDTH // 2, HEIGHT // 2
        rw = int(self.num_lanes * LANE_WIDTH_PX)
        cr = int(CORNER_RADIUS)

        # road cross + corner squares (Renderer.cpp:520-550 / RoadGeometry)
        d.rectangle([cx - rw, 0, cx + rw, HEIGHT], fill=_ROAD)
        d.rectangle([0, cy - rw, WIDTH, cy + rw], fill=_ROAD)
        for sx in (-1, 1):
            for sy in (-1, 1):
                x0 = cx + (rw if sx > 0 else -rw - cr)
                y0 = cy + (rw if sy > 0 else -rw - cr)
                d.rectangle([x0, y0, x0 + cr, y0 + cr], fill=_ROAD)
                gx = cx + sx * (rw + cr)
                gy = cy + sy * (rw + cr)
                d.ellipse([gx - cr, gy - cr, gx + cr, gy + cr], fill=_GRASS)

        # yellow center lines stopping rw+cr from center (LineMask.cpp:47-72)
        stop = rw + cr
        for off in (-2, 2):
            d.line([cx + off, 0, cx + off, cy - stop], fill=_YELLOW, width=2)
            d.line([cx + off, cy + stop, cx + off, HEIGHT], fill=_YELLOW, width=2)
            d.line([0, cy + off, cx - stop, cy + off], fill=_YELLOW, width=2)
            d.line([cx + stop, cy + off, WIDTH, cy + off], fill=_YELLOW, width=2)

        # dashed lane separators (Renderer.cpp:480-518 draw_lane_dashes):
        # 20 px dash / 20 px gap phased from the screen edge toward the stop
        # offset, last segment clamped so dashes never cross the stop line
        def dash(x0, y0, x1, y1):
            dist = float(np.hypot(x1 - x0, y1 - y0))
            if dist <= 0:
                return
            dash_len = 20.0
            steps = int(dist / (dash_len * 2))
            dx_, dy_ = (x1 - x0) / dist, (y1 - y0) / dist
            for i in range(steps + 1):
                sx = x0 + dx_ * i * dash_len * 2
                sy = y0 + dy_ * i * dash_len * 2
                ex_, ey_ = sx + dx_ * dash_len, sy + dy_ * dash_len
                if (i * dash_len * 2 + dash_len) / dist >= 1.0:
                    ex_, ey_ = x1, y1
                d.line([sx, sy, ex_, ey_], fill=_WHITE, width=2)

        for k in range(1, self.num_lanes):
            off = k * int(LANE_WIDTH_PX)
            dash(cx - off, 0, cx - off, cy - stop)
            dash(cx + off, 0, cx + off, cy - stop)
            dash(cx - off, HEIGHT, cx - off, cy + stop)
            dash(cx + off, HEIGHT, cx + off, cy + stop)
            dash(0, cy - off, cx - stop, cy - off)
            dash(0, cy + off, cx - stop, cy + off)
            dash(WIDTH, cy - off, cx + stop, cy - off)
            dash(WIDTH, cy + off, cx + stop, cy + off)

        # stop lines (Renderer.cpp:427-437): white, width 4, half-road
        # segments on the incoming side of each approach
        d.line([cx - rw, cy - stop, cx, cy - stop], fill=_WHITE, width=4)
        d.line([cx, cy + stop, cx + rw, cy + stop], fill=_WHITE, width=4)
        d.line([cx - stop, cy, cx - stop, cy + rw], fill=_WHITE, width=4)
        d.line([cx + stop, cy, cx + stop, cy - rw], fill=_WHITE, width=4)

        # road boundaries + rounded-corner quarter arcs (Renderer.cpp:439-476)
        bw = 3
        d.line([cx - rw, 0, cx - rw, cy - rw - cr], fill=_BOUNDARY, width=bw)
        d.line([cx + rw, 0, cx + rw, cy - rw - cr], fill=_BOUNDARY, width=bw)
        d.line([cx - rw, HEIGHT, cx - rw, cy + rw + cr], fill=_BOUNDARY, width=bw)
        d.line([cx + rw, HEIGHT, cx + rw, cy + rw + cr], fill=_BOUNDARY, width=bw)
        d.line([0, cy - rw, cx - rw - cr, cy - rw], fill=_BOUNDARY, width=bw)
        d.line([0, cy + rw, cx - rw - cr, cy + rw], fill=_BOUNDARY, width=bw)
        d.line([WIDTH, cy - rw, cx + rw + cr, cy - rw], fill=_BOUNDARY, width=bw)
        d.line([WIDTH, cy + rw, cx + rw + cr, cy + rw], fill=_BOUNDARY, width=bw)
        # arc centers == grass-circle centers; PIL angles are clockwise
        # from 3 o'clock in y-down screen space
        for (ax, ay, a0, a1) in [
            (cx - rw - cr, cy - rw - cr, 0, 90),      # top-left corner
            (cx + rw + cr, cy - rw - cr, 90, 180),    # top-right
            (cx - rw - cr, cy + rw + cr, 270, 360),   # bottom-left
            (cx + rw + cr, cy + rw + cr, 180, 270),   # bottom-right
        ]:
            d.arc([ax - cr, ay - cr, ax + cr, ay + cr], a0, a1,
                  fill=_BOUNDARY, width=bw)
        return img

    # ------------------------------------------------------------------ frame
    def render(self, state, show_lane_ids: bool = False, show_lidar: bool = False,
               show_route: bool = True, show_hud: bool = True, env: int = 0) -> np.ndarray:
        """The frame of env ``env`` of ``state`` (an ``EnvState`` on any
        device, or a ``host_state`` view), (HEIGHT, WIDTH, 3) uint8."""
        from PIL import ImageDraw

        state = host_state(state, env)
        img = self._bg.copy()
        d = ImageDraw.Draw(img)

        ego = state.ego
        ex = np.asarray(ego.x, np.float64)
        ey = np.asarray(ego.y, np.float64)
        eh = np.asarray(ego.heading, np.float64)

        if show_route and len(ex) > 0:  # car 0's route (Renderer.cpp:377-403)
            rid = int(np.asarray(ego.route_id)[0])
            path = self.env.table.paths[rid]
            d.line([tuple(p) for p in path.tolist()], fill=_ROUTE, width=2)
            # car-0 lookahead target dot, red r=4 (Renderer.cpp:391-402)
            la = min(int(np.asarray(ego.path_index)[0]) + 10, len(path) - 1)
            px, py = path[la]
            d.ellipse([px - 4, py - 4, px + 4, py + 4], fill=_TARGET)

        npc = state.npc
        nalive = np.asarray(npc.alive)
        for i in np.nonzero(nalive)[0]:
            self._draw_car(d, float(np.asarray(npc.x)[i]), float(np.asarray(npc.y)[i]),
                           float(np.asarray(npc.heading)[i]), _NPC_COLOR)

        for i in range(len(ex)):
            color = _CAR_COLORS[i % len(_CAR_COLORS)]
            self._draw_car(d, float(ex[i]), float(ey[i]), float(eh[i]), color)

        if show_lidar:  # hit-only rays (Renderer.cpp:612-645)
            lid = np.asarray(state.lidar)
            for i in range(len(ex)):
                for r in range(LIDAR_RAYS):
                    dist = float(lid[i, r])
                    if dist >= LIDAR_MAX_DIST:
                        continue
                    a = eh[i] + float(self._rel_angles[r])
                    hx = ex[i] + np.cos(a) * dist
                    hy = ey[i] - np.sin(a) * dist
                    d.line([ex[i], ey[i], hx, hy], fill=_LIDAR_HIT, width=1)

        if show_lane_ids:
            layout = self.env.table.layout
            for name, (x, y) in layout["points"].items():
                d.text((x - 10, y - 5), name, fill=_WHITE)

        if show_hud:  # step / agents alive / traffic count / ego-0 speed (Renderer.cpp:344-373)
            ego_alive = getattr(ego, "alive", None)
            alive = int(np.asarray(ego_alive).sum()) if ego_alive is not None else len(ex)
            ntraffic = int(nalive.sum())
            lines = [f"step: {int(np.asarray(state.step_count))}",
                     f"agents alive: {alive}/{len(ex)}",
                     f"traffic: {ntraffic}"]
            if len(ex) > 0:
                lines.append(f"ego v: {float(np.asarray(ego.v)[0]):.2f} px/f")
            for li, text in enumerate(lines):
                d.text((6, 6 + 12 * li), text, fill=_WHITE)

        return np.asarray(img, np.uint8)

    def _draw_car(self, d, x: float, y: float, heading: float, color):
        hl, hw = CAR_LENGTH / 2, CAR_WIDTH / 2
        c, s = np.cos(heading), np.sin(heading)
        # screen-space corners: y-down, heading y-up => rotate by -heading
        pts = []
        for lx, ly in [(hl, hw), (hl, -hw), (-hl, -hw), (-hl, hw)]:
            pts.append((x + lx * c + ly * s, y - lx * s + ly * c))
        d.polygon(pts, fill=color, outline=(0, 0, 0))
        # heading marker (Renderer.cpp:553-609 nose triangle, simplified)
        d.line([x, y, x + hl * c, y - hl * s], fill=(0, 0, 0), width=2)

    # -------------------------------------------------------------- human mode
    def show(self, frame: np.ndarray):
        """Best-effort interactive display; headless-safe (saves the frame
        as mti_frame.png in the temporary directory)."""
        try:
            import matplotlib
            import matplotlib.pyplot as plt
            if matplotlib.get_backend().lower() == "agg":
                raise RuntimeError("headless")
            if not hasattr(self, "_fig"):
                plt.ion()
                self._fig, self._ax = plt.subplots()
                self._im = self._ax.imshow(frame)
            else:
                self._im.set_data(frame)
            self._fig.canvas.draw_idle()
            plt.pause(0.001)
        except Exception:
            from PIL import Image
            Image.fromarray(frame).save(os.path.join(tempfile.gettempdir(), "mti_frame.png"))

    def close(self):
        if hasattr(self, "_fig"):
            import matplotlib.pyplot as plt
            plt.close(self._fig)
            del self._fig
