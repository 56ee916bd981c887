"""Gradient-magnitude pyramid construction (main.cpp:12-50).

Level 0 is the Sobel gradient magnitude of the input (quirk Q1); each
coarser level is a 0.5x INTER_LINEAR decimation of the previous level.
Every level carries its own Sobel dx/dy of the magnitude image and is
padded by ``img_padding``: replicate for the image, zeros for the
gradients (main.cpp:41-49).
"""

from __future__ import annotations

import os
from typing import List, NamedTuple

import jax.numpy as jnp

from . import image as im


class PyramidLevel(NamedTuple):
    img: jnp.ndarray   # [h + 2p, w + 2p] replicate-padded magnitude image
    dx: jnp.ndarray    # [h + 2p, w + 2p] zero-padded Sobel d/dx
    dy: jnp.ndarray    # [h + 2p, w + 2p] zero-padded Sobel d/dy
    width: int         # unpadded w at this level
    height: int        # unpadded h at this level


def construct_pyramid(img: jnp.ndarray, coarsest_scale: int,
                      img_padding: int) -> List[PyramidLevel]:
    """Returns levels[0..coarsest], finest first (level index == scale)."""
    levels: List[PyramidLevel] = []
    p = img_padding
    cur = im.gradient_magnitude(img)
    for s in range(coarsest_scale + 1):
        if s > 0:
            cur = im.resize_half(cur)
        dx = im.sobel3(cur, "x")
        dy = im.sobel3(cur, "y")
        h, w = cur.shape
        levels.append(
            PyramidLevel(
                img=im.replicate_pad(cur, p, p, p, p),
                dx=im.constant_pad(dx, p, p, p, p),
                dy=im.constant_pad(dy, p, p, p, p),
                width=w,
                height=h,
            )
        )
    return _barrier_levels(levels)


# Fence the pyramid from consumer-driven fusion (default on).  XLA's
# fusion is CONSUMER-shaped: the same Sobel/magnitude/decimate subgraph
# compiles with different fma/vectorization choices depending on what
# reads it, so an untiled program and a shard_map-tiled program consuming
# the identical pyramid math produce ulp-different level planes, which
# the patch search then amplifies through discrete policing decisions
# (round-2 "~1e-5 reassociation noise", root-caused in round 3).  An
# optimization_barrier on each level's planes makes the pyramid its own
# fusion island — identical in every program context — which makes
# grid-tiled SPMD execution BITWISE equal to the untiled pipeline
# (tests/test_parallel.py).  The cost is only lost producer fusion into
# the first consumer slice of each plane; the planes are materialized
# buffers anyway.
_BARRIER = os.environ.get("DIS_TPU_PYRAMID_BARRIER", "1") == "1"


def _barrier_levels(levels: "List[PyramidLevel]") -> "List[PyramidLevel]":
    if not _BARRIER:
        return levels
    from jax import lax

    out = []
    for l in levels:
        i_, dx_, dy_ = lax.optimization_barrier((l.img, l.dx, l.dy))
        out.append(PyramidLevel(img=i_, dx=dx_, dy=dy_,
                                width=l.width, height=l.height))
    return out


def intensity_pyramid(img: jnp.ndarray, coarsest_scale: int) -> list:
    """Raw-intensity OpenCV-resize chain ``[img, img/2, ...]`` (unpadded
    planes, one per scale) for ``refinement_planes="intensity"``
    (config.py): the DIS paper's variational refinement reads the
    intensity image, whereas the reference's pyramid levels are
    gradient-magnitude planes (quirk Q1, main.cpp:18-29).  Uses the same
    INTER_LINEAR x0.5 decimation as the Q1 levels, so tiled and untiled
    pipelines derive bit-identical planes.  The planes carry the same
    fusion fence as the Q1 levels (_BARRIER note above): they feed the
    refinement whose output seeds the next scale's search, so context-
    dependent fusion would break bitwise tiled == untiled."""
    from jax import lax

    out = [img]
    for _ in range(coarsest_scale):
        out.append(im.resize_half(out[-1]))
    if _BARRIER:
        out = list(lax.optimization_barrier(tuple(out)))
    return out
