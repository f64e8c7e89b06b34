"""World constants for the unsignalized-intersection MARL environment.

The reference simulator's constants (reference: cpp/constants.h:1-20).
All values are float32-exact; the world is a 750x750-pixel canvas with y-down
screen coordinates and headings measured y-up (see physics.py).
"""
from __future__ import annotations

import math

# Canvas (reference: cpp/constants.h:4-5)
WIDTH: int = 750
HEIGHT: int = 750

# Units (reference: cpp/constants.h:7-9)
SCALE: float = 12.0            # px per meter
FPS: float = 60.0
DT_DEFAULT: float = 1.0 / 60.0

# Vehicle geometry in px (reference: cpp/constants.h:11-13)
CAR_LENGTH: float = 54.0       # int(4.5 m * 12)
CAR_WIDTH: float = 24.0        # int(2.0 m * 12)
WHEELBASE: float = CAR_LENGTH

# Road geometry (reference: cpp/constants.h:15-16)
LANE_WIDTH_PX: float = 42.0    # int(3.5 m * 12)
CORNER_RADIUS: float = 84.0    # int(7 m * 12)

# Dynamics limits (reference: cpp/constants.h:18-20)
MAX_ACC: float = 15.0
MAX_STEERING_ANGLE: float = 0.6108652381980153  # radians(35)
PHYSICS_MAX_SPEED: float = 8.0  # px/frame

# Observation layout (reference: utils.py:11, cpp/IntersectionEnv.h:19)
NEIGHBOR_COUNT: int = 5
OBS_DIM: int = 127

# Lidar as configured by the env at car creation
# (reference: cpp/IntersectionEnv.cpp:113-127 overrides the 72-ray default
#  of cpp/Lidar.h:11 to 96 rays / 360 deg / 250 px / 4 px march step)
LIDAR_RAYS: int = 96
LIDAR_FOV_DEG: float = 360.0
LIDAR_MAX_DIST: float = 250.0
LIDAR_STEP: float = 4.0
# Number of march samples: dist = 0, 4, ..., < 250  ->  63 samples
LIDAR_SAMPLES: int = int(math.ceil(LIDAR_MAX_DIST / LIDAR_STEP))  # 63

# Route paths are fixed-length polylines: 50 approach + 60 middle + 50 exit
# (reference: cpp/RouteGen.cpp:127-205)
PATH_LEN: int = 160

# Agent status taxonomy (reference status strings,
# cpp/IntersectionEnv.cpp:147,169,206,227,240,282,302)
STATUS_ALIVE: int = 0
STATUS_DEAD: int = 1
STATUS_SUCCESS: int = 2
STATUS_CRASH_WALL: int = 3
STATUS_CRASH_LINE: int = 4
STATUS_CRASH_CAR: int = 5

STATUS_NAMES = ("ALIVE", "DEAD", "SUCCESS", "CRASH_WALL", "CRASH_LINE", "CRASH_CAR")

PI_F = float.fromhex("0x1.921fb6p+1")  # float32(pi), matches C++ PI_F literal rounding
