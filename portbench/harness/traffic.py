"""The one generator of traffic: a traffic file (``portbench/traffic/
<name>.json``) gives the sizes, and the seed the values, made on the device.

A window is what the program takes as one sample: T frames of V camera
views (standard normal, as normalised frames are), the vehicle's pose at
each frame (pixel position and heading, moving by up to ``motion_px``
pixels and turning by up to ``turn_rad`` a frame), the vehicle type 0 and
the map tile under it (uniform in [0, 1)). Every seed gives the same sizes.
"""

from __future__ import annotations

import math

import torch

from portbench.harness.weights import mix


def windows(tr: dict, T: int, n: int, seed: int, tag: int, device) -> dict:
    """``n`` windows of ``T`` frames of traffic ``tr`` from (seed, tag):
    camera (n, T, V, H, W, 3), vehicle_pose (n, T, 3), vehicle_type (n, 1)
    int32, map (n, tile, tile, 3)."""
    V = tr["views"]
    gen = torch.Generator(device=device)
    gen.manual_seed(mix(seed, tag))
    cam = torch.randn((n, T, V, tr["height"], tr["width"], 3), generator=gen,
                      device=device)
    u = torch.rand((n, 3 + 2 * T), generator=gen, device=device)
    x0 = 100.0 + 800.0 * u[:, 0]
    y0 = 100.0 + 800.0 * u[:, 1]
    h0 = (2.0 * u[:, 2] - 1.0) * math.pi
    speed = tr["motion_px"] * u[:, 3:3 + T]
    turn = tr["turn_rad"] * (2.0 * u[:, 3 + T:3 + 2 * T] - 1.0)
    heading = h0[:, None] + torch.cumsum(turn, 1) - turn[:, :1]
    step = speed - speed[:, :1]
    x = x0[:, None] + torch.cumsum(step * torch.cos(heading), 1)
    y = y0[:, None] + torch.cumsum(step * torch.sin(heading), 1)
    pose = torch.stack([x, y, heading], -1)
    tile = tr.get("tile", 224)
    mp = torch.rand((n, tile, tile, 3), generator=gen, device=device)
    return {"camera": cam, "vehicle_pose": pose,
            "vehicle_type": torch.zeros((n, 1), dtype=torch.int32,
                                        device=device),
            "map": mp}


def tiles(n: int, size: int, seed: int, device) -> torch.Tensor:
    """``n`` map tiles (n, size, size, 3) uniform in [0, 1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(mix(seed, 9001))
    return torch.rand((n, size, size, 3), generator=gen, device=device)


def rows(batch: dict, sl) -> dict:
    return {k: v[sl] for k, v in batch.items()}
