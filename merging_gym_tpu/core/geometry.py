"""Lane geometry and collision predicate, as pure jnp functions.

The reference computes vehicle screen coordinates from longitudinal arc
position (merging_gym/envs/merging_env.py:48-58) and tests collision by
building pygame rects at those coordinates and intersecting shapely
polygons (merging_env.py:198-206, 232-239).  Both vehicles always have
yaw 0, so the polygon test reduces to an axis-aligned box-overlap test
on *rounded* centres:

* ``pygame.Surface.get_rect(center=(x, y))`` rounds the float centre to
  integers half-away-from-zero (verified empirically against pygame 2.6),
* ``shapely.Polygon.intersects`` counts boundary touching as intersection,
  so the comparisons are inclusive (``<=``).

This module is the on-device replacement for the GEOS/pygame dependency:
branch-free elementwise math that vmaps over thousands of envs.
"""

import jax.numpy as jnp

from merging_gym_tpu.core import constants as C


def lon2coord(lon, side):
    """Longitudinal arc position -> (x, y) screen coordinates.

    ``side`` is +1 for player 1 ("ego", right arc) and -1 for player 2
    ("opponent", mirrored left arc).  Reference: merging_env.py:48-58.

    The reference computes ``y = W/2 +- (R - R*cos(angle))``; we use the
    cancellation-free versine identity ``R - R*cos(a) == 2*R*sin(a/2)**2``
    which is exact to ulp in f64 and far more accurate in f32 (the direct
    form loses ~5 decimal digits at R=3e4).
    """
    angle = C.ANGLE0 - lon / C.R
    x = C.R * jnp.sin(angle)
    half = 0.5 * angle
    versine = 2.0 * C.R * jnp.sin(half) * jnp.sin(half)
    y = C.W / 2 + side * versine
    return x, y


def round_half_away(v):
    """Round half-away-from-zero, matching pygame's Rect centre rounding.

    All coordinates in this game are positive, so ``floor(v + 0.5)``
    suffices; we keep the signed form for robustness.
    """
    return jnp.sign(v) * jnp.floor(jnp.abs(v) + 0.5)


def is_collided(x1, y1, x2, y2):
    """Axis-aligned overlap test equivalent to the reference polygon check.

    The reference (merging_env.py:198-206) builds two 4(wide) x 8(tall)
    pygame rects centred at the *rounded* coordinates -- note the swapped
    call ``corners(agent, x_i, y_i)`` into ``corners(self, agent, y, x)``
    (merging_env.py:201-202, 232), so the env's ``y`` (lateral) maps to the
    rect's 4-unit width and the env's ``x`` (longitudinal) to the 8-unit
    height.  Two such rects intersect (touch-inclusive) iff the rounded
    centre deltas are within the summed half-extents.
    """
    cx1, cy1 = round_half_away(x1), round_half_away(y1)
    cx2, cy2 = round_half_away(x2), round_half_away(y2)
    lon_hit = jnp.abs(cx1 - cx2) <= C.VEHICLE_H
    lat_hit = jnp.abs(cy1 - cy2) <= C.VEHICLE_W
    return lon_hit & lat_hit
