"""The control for `correct`: the reference with the values it hands from
stage to stage held in bfloat16, the precision below the float32 that the
configurations state. The quad fit's corners, the refined corners and the
pose come out of their stages rounded to bfloat16 (8 significant bits,
round to nearest even); decode and pose then work from those, and a quad
that rounding made degenerate decodes as no tag. A
comparison that cannot tell this from the reference cannot tell a
lower-precision detector from the port.
"""
from __future__ import annotations

import contextlib

import numpy as np

from benchmark.reference import geometry, oracle


def bf16(x):
    """float -> the nearest bfloat16 value (ties to even), as float64."""
    a = np.ascontiguousarray(np.asarray(x, np.float32))
    bits = a.view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return bits.astype(np.uint32).view(np.float32).astype(np.float64) \
        .reshape(np.shape(x))


@contextlib.contextmanager
def bf16_stages():
    fit, refine, decode, pose = (oracle.fit_quad, oracle.refine_edges,
                                 oracle.quad_decode,
                                 geometry.estimate_tag_pose)

    def fit_quad(*a, **kw):
        q = fit(*a, **kw)
        return None if q is None else bf16(q)

    def refine_edges(gray, quad, *a, **kw):
        try:
            return bf16(refine(gray, quad, *a, **kw))
        except (ValueError, OverflowError):  # an edge rounding made empty
            return quad

    def quad_decode(*a, **kw):
        # a quad that rounding made degenerate reads as no tag
        try:
            return decode(*a, **kw)
        except (ValueError, OverflowError, np.linalg.LinAlgError):
            return None

    def estimate_tag_pose(*a, **kw):
        R, t, err = pose(*a, **kw)
        return bf16(R), bf16(t), err

    oracle.fit_quad, oracle.refine_edges = fit_quad, refine_edges
    oracle.quad_decode = quad_decode
    geometry.estimate_tag_pose = estimate_tag_pose
    try:
        yield
    finally:
        oracle.fit_quad, oracle.refine_edges = fit, refine
        oracle.quad_decode = decode
        geometry.estimate_tag_pose = pose
