"""GEO (geometric partitioning merge, GPM) and CIIP.

Behavioral reference: vvenc CommonLib/Rom.cpp (initGeoTemplate:1304,
g_angle2mask/g_Dis/g_angle2mirror:1376-1382), InterpolationFilter.cpp
(xWeightedGeoBlk:1005), UnitTools.cpp (getGeoMergeCandidates:3099,
spanGeoMotionInfo:3161), DecCu.cpp (CIIP blend :307-334), Buffer.cpp
(weightCiipCore:60), IntraPrediction.h (getNumIntraCiip:176).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .motion import MotionInfo, get_merge_candidates
from ..ops.interp import IF_INTERNAL_PREC, IF_INTERNAL_OFFS

GEO_MIN_CU_SIZE = 8
GEO_MAX_CU_SIZE = 64
GEO_NUM_PARTITION_MODE = 64
GEO_NUM_ANGLES = 32
GEO_NUM_DISTANCES = 4
GEO_MASK = 3 * (GEO_MAX_CU_SIZE >> 3) * 2 + GEO_MAX_CU_SIZE  # 112
GEO_MAX_NUM_UNI = 6

ANGLE2MASK = (0, -1, 1, 2, 3, 4, -1, -1, 5, -1, -1, 4, 3, 2, 1, -1,
              0, -1, 1, 2, 3, 4, -1, -1, 5, -1, -1, 4, 3, 2, 1, -1)
DIS = (8, 8, 8, 8, 4, 4, 2, 1, 0, -1, -2, -4, -4, -8, -8, -8,
       -8, -8, -8, -8, -4, -4, -2, -1, 0, 1, 2, 4, 4, 8, 8, 8)
ANGLE2MIRROR = (0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 2)


def _build_tables():
    params = []
    for a in range(GEO_NUM_ANGLES):
        for d in range(GEO_NUM_DISTANCES):
            if (d == 0 and a >= 16) or \
               ((d in (0, 2)) and ANGLE2MASK[a] in (0, 5)) or \
               ANGLE2MASK[a] == -1:
                continue
            params.append((a, d))
    assert len(params) == GEO_NUM_PARTITION_MODE
    weights = np.zeros((6, GEO_MASK, GEO_MASK), np.int16)
    for a in range((GEO_NUM_ANGLES >> 2) + 1):
        if ANGLE2MASK[a] == -1:
            continue
        dx, dy = a, (a + (GEO_NUM_ANGLES >> 2)) % GEO_NUM_ANGLES
        rho = DIS[dx] * 2 * GEO_MAX_CU_SIZE + DIS[dy] * 2 * GEO_MAX_CU_SIZE
        moff = (2 * GEO_MAX_CU_SIZE - GEO_MASK) >> 1
        ys = (((np.arange(GEO_MASK) + moff) << 1) + 1) * DIS[dy]
        xs = (((np.arange(GEO_MASK) + moff) << 1) + 1) * DIS[dx]
        widx = xs[None, :] + ys[:, None] - rho
        weights[ANGLE2MASK[a]] = np.clip((widx + 32 + 4) >> 3, 0, 8)
    offs = np.zeros((4, 4, GEO_NUM_PARTITION_MODE, 2), np.int32)
    for hidx in range(4):
        h = 1 << (hidx + 3)
        for widx in range(4):
            w = 1 << (widx + 3)
            for sd in range(GEO_NUM_PARTITION_MODE):
                ang, dist = params[sd]
                ox = (GEO_MASK - w) >> 1
                oy = (GEO_MASK - h) >> 1
                if dist > 0:
                    if ang % 16 == 8 or (ang % 16 != 0 and h >= w):
                        oy += (dist * h) >> 3 if ang < 16 \
                            else -((dist * h) >> 3)
                    else:
                        ox += (dist * w) >> 3 if ang < 16 \
                            else -((dist * w) >> 3)
                offs[hidx, widx, sd] = (ox, oy)
    return tuple(params), weights, offs


GEO_PARAMS, GEO_WEIGHTS, GEO_WEIGHT_OFFSET = _build_tables()


def geo_available(coder, cu) -> bool:
    """CABACWriter::merge_data geoAvailable (CABACWriter.cpp:1552)."""
    mn, mx = min(cu.w, cu.h), max(cu.w, cu.h)
    return (coder.geo_en and coder.is_b and coder.max_geo_cand > 1
            and mn >= GEO_MIN_CU_SIZE and mx <= GEO_MAX_CU_SIZE
            and mx < 8 * mn)


def ciip_available(coder, cu) -> bool:
    return (coder.ciip_en and not cu.skip and max(cu.w, cu.h) < 128
            and cu.w * cu.h >= 64)


def geo_merge_candidates(coder, ps, cu) -> List[MotionInfo]:
    """Uni-directional geo candidate list (getGeoMergeCandidates:3099)."""
    base = get_merge_candidates(ps, coder.mf, coder.hmvp, cu.x, cu.y,
                                cu.w, cu.h, coder.sps.max_num_merge_cand,
                                coder.is_b, coder.num_refs, coder.tmvp)
    out: List[MotionInfo] = []
    for i, mi in enumerate(base):
        parity = i & 1
        for li in (parity, 1 - parity):
            if mi.ref_idx[li] >= 0:
                mv = [(0, 0), (0, 0)]
                ref = [-1, -1]
                mv[li] = mi.mv[li]
                ref[li] = mi.ref_idx[li]
                out.append(MotionInfo((tuple(mv[0]), tuple(mv[1])),
                                      (ref[0], ref[1])))
                break
        if len(out) == GEO_MAX_NUM_UNI:
            break
    return out


def _weight_plane(cu, split_dir: int, sc: int) -> np.ndarray:
    """Per-pixel weight of partition 0 for one component
    (xWeightedGeoBlk:1005 pointer walk, expressed as coordinates)."""
    ang = GEO_PARAMS[split_dir][0]
    widx = (cu.w.bit_length() - 1) - 3
    hidx = (cu.h.bit_length() - 1) - 3
    ox, oy = GEO_WEIGHT_OFFSET[hidx, widx, split_dir]
    mask = GEO_WEIGHTS[ANGLE2MASK[ang]]
    w_c, h_c = cu.w >> sc, cu.h >> sc
    xs = np.arange(w_c) << sc
    ys = np.arange(h_c) << sc
    mirror = ANGLE2MIRROR[ang]
    if mirror == 2:
        rows = (GEO_MASK - 1 - oy) - ys
        cols = ox + xs
    elif mirror == 1:
        rows = oy + ys
        cols = (GEO_MASK - 1 - ox) - xs
    else:
        rows = oy + ys
        cols = ox + xs
    return mask[np.ix_(rows, cols)].astype(np.int64)


def geo_blend(cu, pred0: np.ndarray, pred1: np.ndarray, comp: int,
              bit_depth: int, split_dir: int) -> np.ndarray:
    """Weighted blend of the two uni predictions (14-bit intermediates)."""
    sc = 0 if comp == 0 else 1
    w = _weight_plane(cu, split_dir, sc)
    shift = max(2, IF_INTERNAL_PREC - bit_depth) + 3
    offset = (1 << (shift - 1)) + (IF_INTERNAL_OFFS << 3)
    out = (w * pred0.astype(np.int64) + (8 - w) * pred1.astype(np.int64)
           + offset) >> shift
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(np.int32)


def geo_motion_grid(cu, mi0: MotionInfo, mi1: MotionInfo,
                    split_dir: int) -> list:
    """Per-4x4 stored motion (spanGeoMotionInfo:3161)."""
    d0, d1 = mi0.inter_dir, mi1.inter_dir
    if d0 == 1 and d1 == 2:
        bi = MotionInfo((mi0.mv[0], mi1.mv[1]),
                        (mi0.ref_idx[0], mi1.ref_idx[1]))
    elif d0 == 2 and d1 == 1:
        bi = MotionInfo((mi1.mv[0], mi0.mv[1]),
                        (mi1.ref_idx[0], mi0.ref_idx[1]))
    elif d0 == 1 and d1 == 1:
        bi = MotionInfo((mi1.mv[0], (0, 0)), (mi1.ref_idx[0], -1))
    else:
        bi = MotionInfo(((0, 0), mi1.mv[1]), (-1, mi1.ref_idx[1]))
    ang, dist = GEO_PARAMS[split_dir]
    is_flip = 13 <= ang <= 27
    dx, dy = ang, (ang + (GEO_NUM_ANGLES >> 2)) % GEO_NUM_ANGLES
    ox = (-cu.w) >> 1
    oy = (-cu.h) >> 1
    if dist > 0:
        if ang % 16 == 8 or (ang % 16 != 0 and cu.h >= cu.w):
            oy += (dist * cu.h) >> 3 if ang < 16 else -((dist * cu.h) >> 3)
        else:
            ox += (dist * cu.w) >> 3 if ang < 16 else -((dist * cu.w) >> 3)
    grid = []
    for y in range(cu.h // 4):
        row = []
        luy = (2 * (4 * y + oy) + 5) * DIS[dy]
        for x in range(cu.w // 4):
            midx = (2 * (4 * x + ox) + 5) * DIS[dx] + luy
            mask = 2 if abs(midx) < 32 else \
                ((1 - is_flip) if midx <= 0 else int(is_flip))
            row.append(bi if mask == 2 else (mi0 if mask == 0 else mi1))
        grid.append(row)
    return grid


def geo_predict(coder, cu, comp: int) -> np.ndarray:
    """Geo CU prediction: two uni MCs + weighted blend."""
    from .ctu_syntax import inter_predict
    sc = 0 if comp == 0 else 1
    preds = []
    for mi in cu.geo_mi:
        li = 0 if mi.ref_idx[0] >= 0 else 1
        from ..ops.interp import mc_block_np
        ref = coder.ref_pics[li][mi.ref_idx[li]][comp]
        preds.append(mc_block_np(ref, cu.x >> sc, cu.y >> sc, cu.w >> sc,
                                 cu.h >> sc, mi.mv[li][0], mi.mv[li][1],
                                 coder.bit_depth, is_luma=(comp == 0),
                                 intermediate=True))
    return geo_blend(cu, preds[0], preds[1], comp, coder.bit_depth,
                     cu.geo_split_dir)


def ciip_blend(inter: np.ndarray, intra: np.ndarray, num_intra: int,
               ) -> np.ndarray:
    """weightCiipCore (Buffer.cpp:60): blend final-precision predictions."""
    a = inter.astype(np.int64)
    b = intra.astype(np.int64)
    if num_intra == 1:
        return ((a + b + 1) >> 1).astype(np.int32)
    if num_intra == 2:
        return ((a + 3 * b + 2) >> 2).astype(np.int32)
    return ((b + 3 * a + 2) >> 2).astype(np.int32)


def ciip_num_intra(ps, cu) -> int:
    """getNumIntraCiip (IntraPrediction.h:176): left of bottom-left +
    above of top-right intra-ness."""
    n = 0
    for px, py in ((cu.x - 1, cu.y + cu.h - 1), (cu.x + cu.w - 1, cu.y - 1)):
        if ps.is_coded(px, py) and bool(ps.is_intra[py >> 2, px >> 2]):
            n += 1
    return n
