"""The interactive state and its per-frame step: the reference's key handling
(Render.cpp:89-209) as a pure update, `step(sim, keys, frame_ms)` -> new sim.

Torch counterpart of `relativitypathtracer_tpu.utils.framestate`. The step is
host numpy float32, bit for bit with the JAX package's; it wraps its result
in a FrameState of CPU float32 tensors and never touches the device (the
viewer copies the two small vectors to the card when it renders). A frame is
therefore reproducible from the scene file and the key timeline.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from ..render import FrameState

KEY_W, KEY_A, KEY_S, KEY_D, KEY_Q, KEY_E, KEY_R, KEY_SPACE, KEY_I = range(9)

_KEY_DIRS = np.array(
    [
        [0, 0, 1],   # w: forward
        [-1, 0, 0],  # a: left
        [0, 0, -1],  # s: back
        [1, 0, 0],   # d: right
        [0, -1, 0],  # q: down
        [0, 1, 0],   # e: up
    ],
    np.float32,
)


class SimState(NamedTuple):
    """FrameState plus the host-side toggles (pause, interval, key edges)."""

    frame: FrameState
    paused: bool = True  # scenes start paused (Render.cpp:12)
    interval: int = -1
    prev_space: bool = False
    prev_i: bool = False

    @staticmethod
    def initial(default_interval: int = -1, device=DEFAULT_DEVICE) -> "SimState":
        return SimState(frame=FrameState.initial(device), interval=int(default_interval))


def _host(x) -> np.ndarray:
    """float32 numpy of a tensor (copied off the card if it lives there) or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def add_velocity_np(v1, v2):
    """Relativistic velocity composition in numpy float32: the closed form of
    ops.relmath.add_velocity (Vector.cpp:189-193), which the step runs every
    frame on the host."""
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    one = np.float32(1.0)
    gamma = one / np.float32(np.sqrt(one - np.float32(v1 @ v1)))
    coef = gamma / (one + gamma)
    num = v1 + v2 + coef * np.cross(v1, np.cross(v1, v2)).astype(np.float32)
    return (num / (one + np.float32(v2 @ v1))).astype(np.float32)


def step(sim: SimState, keys, frame_ms: float) -> SimState:
    """Advance one frame: velocity controls, pause/interval toggles, time.

    keys: 9 bools indexed by KEY_*; frame_ms: wall ms since the last frame.
    Velocity increments are tanh(frame_ms/5000) * direction, composed
    relativistically (Render.cpp:149-176); space and i act on key-down edges
    (Render.cpp:125-147); scene time advances by frame_ms/1000 when unpaused
    (Render.cpp:177). Reads the state's two vectors on the host (a copy when
    they live on the card) and returns them as CPU tensors."""
    keys = [bool(k) for k in keys]
    paused = sim.paused
    interval = sim.interval
    if keys[KEY_SPACE] and not sim.prev_space:
        paused = not paused
    if keys[KEY_I] and not sim.prev_i:
        interval = -(0 if interval else 1)  # toggles 0 <-> -1

    vel = _host(sim.frame.cam_velocity)
    if keys[KEY_R]:
        vel = np.zeros(3, np.float32)
    else:
        dv = np.zeros(3, np.float32)
        for k in range(6):
            if keys[k]:
                dv += _KEY_DIRS[k]
        if np.linalg.norm(dv) != 0:
            dv = np.tanh(frame_ms / 5000.0) * dv / np.linalg.norm(dv)
            vel = add_velocity_np(vel, dv.astype(np.float32))

    pos = _host(sim.frame.cam_pos)
    if not paused:
        pos = pos + np.array([frame_ms / 1000.0, 0, 0, 0], np.float32)

    return SimState(
        frame=FrameState(cam_velocity=torch.from_numpy(np.array(vel, np.float32)),
                         cam_pos=torch.from_numpy(np.array(pos, np.float32))),
        paused=paused,
        interval=interval,
        prev_space=keys[KEY_SPACE],
        prev_i=keys[KEY_I],
    )
