"""Per-picture coding state: reconstruction planes + per-unit CU maps.

Analog of vvenc's Picture/CodingStructure unit maps (CommonLib/Picture.h:139,
CodingStructure.h:80) reduced to the fields the syntax and prediction
derivations need: coded progress, intra mode, CU geometry, QT depth.
"""

from __future__ import annotations

import numpy as np

from ..ops.intra import PLANAR_IDX


class PictureState:
    """Holds reconstruction and per-4x4-unit (luma) CU attribute maps."""

    LUMA_UNIT = 4
    CHROMA_UNIT = 2  # availability granularity in chroma samples

    def __init__(self, width: int, height: int, bit_depth: int = 10):
        self.w = width
        self.h = height
        self.cw = width >> 1
        self.ch = height >> 1
        self.bit_depth = bit_depth
        mid = 1 << (bit_depth - 1)
        self.rec = {
            0: np.full((height, width), mid, dtype=np.int32),
            1: np.full((self.ch, self.cw), mid, dtype=np.int32),
            2: np.full((self.ch, self.cw), mid, dtype=np.int32),
        }
        uw, uh = (width + 3) // 4, (height + 3) // 4
        self.coded_luma = np.zeros((uh, uw), dtype=bool)
        cuw, cuh = (self.cw + 1) // 2, (self.ch + 1) // 2
        self.coded_chroma = np.zeros((cuh, cuw), dtype=bool)
        # per luma 4x4 unit attribute maps
        self.intra_mode = np.full((uh, uw), PLANAR_IDX, dtype=np.int32)
        self.is_intra = np.zeros((uh, uw), dtype=bool)
        self.is_mip = np.zeros((uh, uw), dtype=bool)
        self.cu_w = np.zeros((uh, uw), dtype=np.int32)
        self.cu_h = np.zeros((uh, uw), dtype=np.int32)
        self.cu_x = np.zeros((uh, uw), dtype=np.int32)
        self.cu_y = np.zeros((uh, uw), dtype=np.int32)
        # dual-tree chroma CU attribute maps (luma-unit dims; used for the
        # chroma tree's split contexts, same grid as coded_chroma)
        self.ccu_w = np.zeros((cuh, cuw), dtype=np.int32)
        self.ccu_h = np.zeros((cuh, cuw), dtype=np.int32)
        self.cqt_depth = np.zeros((cuh, cuw), dtype=np.int32)
        self.qt_depth = np.zeros((uh, uw), dtype=np.int32)
        self.qp_map = np.zeros((uh, uw), dtype=np.int32)  # per-4x4 QpY
        # tiles: per-4x4 tile index; availability is gated to the current
        # tile (CUs of other tiles are treated as outside the picture,
        # vvenc getCURestricted tileIdx check)
        self.tile_map = None            # None = single tile
        self.cur_tile = 0

    # -- attribute queries (positions in luma samples) ---------------------
    def inside(self, x: int, y: int) -> bool:
        return 0 <= x < self.w and 0 <= y < self.h

    def qp_at(self, x: int, y: int):
        """Luma QP of the coded CU covering (x, y), or None (for
        CU::predictQP neighbor lookups, vvenc UnitTools.cpp:324)."""
        if not self.inside(x, y) or not self.is_coded(x, y):
            return None
        return int(self.qp_map[y >> 2, x >> 2])

    def is_coded(self, x: int, y: int) -> bool:
        if not self.inside(x, y) or not bool(self.coded_luma[y >> 2, x >> 2]):
            return False
        return self.tile_map is None or \
            int(self.tile_map[y >> 2, x >> 2]) == self.cur_tile

    # -- tiles -------------------------------------------------------------
    def set_tiles(self, col_bounds, row_bounds) -> None:
        """col_bounds/row_bounds: pixel x/y start positions of tile columns/
        rows (ascending, starting at 0)."""
        uh, uw = self.coded_luma.shape
        self.tile_map = np.zeros((uh, uw), dtype=np.int32)
        ncols = len(col_bounds)
        xs = np.arange(uw) << 2
        ys = np.arange(uh) << 2
        col_idx = np.searchsorted(np.asarray(col_bounds), xs, "right") - 1
        row_idx = np.searchsorted(np.asarray(row_bounds), ys, "right") - 1
        self.tile_map[:] = row_idx[:, None] * ncols + col_idx[None, :]

    def tile_at(self, x: int, y: int) -> int:
        if self.tile_map is None:
            return 0
        return int(self.tile_map[y >> 2, x >> 2])

    def avail_luma(self) -> np.ndarray:
        """Effective luma availability mask (coded AND same tile)."""
        if self.tile_map is None:
            return self.coded_luma
        return self.coded_luma & (self.tile_map == self.cur_tile)

    def avail_chroma(self) -> np.ndarray:
        if self.tile_map is None:
            return self.coded_chroma
        # chroma coded mask is per 2x2-chroma (= 4x4-luma) unit: the tile
        # map has the same granularity
        ch, cw = self.coded_chroma.shape
        sub = self.tile_map[:ch, :cw]
        return self.coded_chroma & (sub == self.cur_tile)

    def cu_at(self, x: int, y: int):
        """(w, h, qt_depth, intra_mode, is_intra, is_mip) of the CU covering
        (x, y), or None if not coded / outside."""
        if not self.is_coded(x, y):
            return None
        uy, ux = y >> 2, x >> 2
        return (int(self.cu_w[uy, ux]), int(self.cu_h[uy, ux]),
                int(self.qt_depth[uy, ux]), int(self.intra_mode[uy, ux]),
                bool(self.is_intra[uy, ux]), bool(self.is_mip[uy, ux]))

    def mark_cu(self, x: int, y: int, w: int, h: int, qt_depth: int,
                intra_mode: int, is_intra: bool = True, is_mip: bool = False,
                with_chroma: bool = True, qp: int = 0):
        """Register a reconstructed CU's attributes + coded progress."""
        ux0, uy0 = x >> 2, y >> 2
        ux1, uy1 = (x + w) >> 2, (y + h) >> 2
        self.coded_luma[uy0:uy1, ux0:ux1] = True
        self.intra_mode[uy0:uy1, ux0:ux1] = intra_mode
        self.is_intra[uy0:uy1, ux0:ux1] = is_intra
        self.is_mip[uy0:uy1, ux0:ux1] = is_mip
        self.cu_w[uy0:uy1, ux0:ux1] = w
        self.cu_h[uy0:uy1, ux0:ux1] = h
        self.cu_x[uy0:uy1, ux0:ux1] = x
        self.cu_y[uy0:uy1, ux0:ux1] = y
        self.qt_depth[uy0:uy1, ux0:ux1] = qt_depth
        self.qp_map[uy0:uy1, ux0:ux1] = qp
        if with_chroma:
            self.mark_chroma(x, y, w, h, qt_depth)

    def mark_chroma(self, x: int, y: int, w: int, h: int,
                    qt_depth: int = 0):
        """Chroma coded mask + chroma-tree CU attributes (4:2:0, luma
        coordinates; dims stored in luma units)."""
        cx0, cy0 = (x >> 1) >> 1, (y >> 1) >> 1
        cx1, cy1 = ((x + w) >> 1) >> 1, ((y + h) >> 1) >> 1
        self.coded_chroma[cy0:cy1, cx0:cx1] = True
        self.ccu_w[cy0:cy1, cx0:cx1] = w
        self.ccu_h[cy0:cy1, cx0:cx1] = h
        self.cqt_depth[cy0:cy1, cx0:cx1] = qt_depth

    def chroma_cu_at(self, x: int, y: int):
        """(w, h, qt_depth) of the chroma-tree CU covering luma (x, y),
        in luma units, or None."""
        if not self.inside(x, y):
            return None
        cy, cx = (y >> 1) >> 1, (x >> 1) >> 1
        if not bool(self.coded_chroma[cy, cx]):
            return None
        if self.tile_map is not None and \
                int(self.tile_map[y >> 2, x >> 2]) != self.cur_tile:
            return None
        return (int(self.ccu_w[cy, cx]), int(self.ccu_h[cy, cx]),
                int(self.cqt_depth[cy, cx]))

    # -- RD-search state checkpointing ------------------------------------
    def save_region(self, x: int, y: int, size: int):
        """Snapshot all state a CU decision inside (x, y, size) can touch."""
        x1 = min(x + size, self.w)
        y1 = min(y + size, self.h)
        cx, cy = x >> 1, y >> 1
        cx1, cy1 = (x1 + 1) >> 1, (y1 + 1) >> 1
        ux, uy, ux1, uy1 = x >> 2, y >> 2, (x1 + 3) >> 2, (y1 + 3) >> 2
        hx, hy, hx1, hy1 = cx >> 1, cy >> 1, (cx1 + 1) >> 1, (cy1 + 1) >> 1
        return (
            (x, y, x1, y1),
            self.rec[0][y:y1, x:x1].copy(),
            self.rec[1][cy:cy1, cx:cx1].copy(),
            self.rec[2][cy:cy1, cx:cx1].copy(),
            self.coded_luma[uy:uy1, ux:ux1].copy(),
            self.coded_chroma[hy:hy1, hx:hx1].copy(),
            self.intra_mode[uy:uy1, ux:ux1].copy(),
            self.is_intra[uy:uy1, ux:ux1].copy(),
            self.is_mip[uy:uy1, ux:ux1].copy(),
            self.cu_w[uy:uy1, ux:ux1].copy(),
            self.cu_h[uy:uy1, ux:ux1].copy(),
            self.qt_depth[uy:uy1, ux:ux1].copy(),
            self.qp_map[uy:uy1, ux:ux1].copy(),
            self.cu_x[uy:uy1, ux:ux1].copy(),
            self.cu_y[uy:uy1, ux:ux1].copy(),
            self.ccu_w[hy:hy1, hx:hx1].copy(),
            self.ccu_h[hy:hy1, hx:hx1].copy(),
            self.cqt_depth[hy:hy1, hx:hx1].copy(),
        )

    def restore_region(self, snap) -> None:
        (x, y, x1, y1) = snap[0]
        cx, cy = x >> 1, y >> 1
        cx1, cy1 = (x1 + 1) >> 1, (y1 + 1) >> 1
        ux, uy, ux1, uy1 = x >> 2, y >> 2, (x1 + 3) >> 2, (y1 + 3) >> 2
        hx, hy, hx1, hy1 = cx >> 1, cy >> 1, (cx1 + 1) >> 1, (cy1 + 1) >> 1
        self.rec[0][y:y1, x:x1] = snap[1]
        self.rec[1][cy:cy1, cx:cx1] = snap[2]
        self.rec[2][cy:cy1, cx:cx1] = snap[3]
        self.coded_luma[uy:uy1, ux:ux1] = snap[4]
        self.coded_chroma[hy:hy1, hx:hx1] = snap[5]
        self.intra_mode[uy:uy1, ux:ux1] = snap[6]
        self.is_intra[uy:uy1, ux:ux1] = snap[7]
        self.is_mip[uy:uy1, ux:ux1] = snap[8]
        self.cu_w[uy:uy1, ux:ux1] = snap[9]
        self.cu_h[uy:uy1, ux:ux1] = snap[10]
        self.qt_depth[uy:uy1, ux:ux1] = snap[11]
        self.qp_map[uy:uy1, ux:ux1] = snap[12]
        self.cu_x[uy:uy1, ux:ux1] = snap[13]
        self.cu_y[uy:uy1, ux:ux1] = snap[14]
        self.ccu_w[hy:hy1, hx:hx1] = snap[15]
        self.ccu_h[hy:hy1, hx:hx1] = snap[16]
        self.cqt_depth[hy:hy1, hx:hx1] = snap[17]
